"""Time the port's batch feed on one CUDA card: the runs of `chip_smoke.py`'s
feed phase (phase 6), longer and with the depths in turns.

    python3 scripts/profile_torch_feed.py [--runs pretrain finetune] \
        [--order 0 2 2 0] [--steps 10] [--trace_dir chiprun_out/feed]

At full width, bf16, weights from a seed: pretrain b16 4f over the port's
`DataLoader` (4 worker threads) on `SyntheticVideoTextDataset`, and the
32-frame Charades-Ego fine-tune (configs/ft_charades.json, B=8, S=6273)
cycling three `synthetic_dual_batch` batches made once. For each run, one
trainer a depth of `--order` (0: `device_prefetch` puts inline; 2: its
feeder thread runs two batches ahead), each from the same seed:
`chip_smoke._feed_run` with 2 warm steps, --steps timed and 2 profiled.
Prints every timed step (each from its next() on the batch iterator to the
end of its device work, `cli._train_loop`), the median and mean, the batch
copies' device time, stream and share inside the device's busy periods, and
whether the losses of a run equal those of its first depth, bit for bit;
with --trace_dir, each run's profiled steps as a gzipped chrome trace there
(the last run of a depth overwrites the earlier).
The card's name and power limit (nvidia-smi) head the output.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", nargs="+", default=["pretrain", "finetune"],
                   choices=["pretrain", "finetune"])
    p.add_argument("--order", nargs="+", type=int, default=[0, 2, 2, 0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--trace_dir", default=None)
    args = p.parse_args(argv)
    smi = chip_smoke.phase_device()
    chip_smoke.FEED_TIMED = args.steps
    runs = {label: (build, source) for label, build, source, _ in
            chip_smoke.feed_runs()}
    for name in args.runs:
        label = "pretrain_b16_4f" if name == "pretrain" else "ft_charades_32f"
        build, source = runs[label]
        first = None
        for depth in args.order:
            r = chip_smoke._feed_run(label, build, source, depth,
                                     args.trace_dir)
            chip_smoke._free()
            ms = [x * 1e3 for x in r["seconds"]]
            c = r["copies"]
            first = first or r["losses"]
            print(f"[feed] {label} depth {depth} ({smi}): steps "
                  f"{[round(x, 1) for x in ms]} ms, median "
                  f"{np.median(ms):.2f}, mean {np.mean(ms):.2f} | copies "
                  f"{c['copies']}, {c['copy_mb']:.1f} MB, {c['copy_ms']:.3f} "
                  f"ms on streams {c['copy_streams']} (kernels "
                  f"{c['kernel_streams']}), {c['in_busy_ms']:.3f} ms inside "
                  f"the device's busy periods | losses equal to the first "
                  f"depth's "
                  f"{r['losses'] == first}", flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
