"""One rank of a data-parallel training run over real processes
(counterpart of `egovlpv2_tpu/parallel/mp_worker.py`): the tiny pretrain
step (or a dual fine-tune step) over `torch.distributed`, each rank fed its
contiguous rows of one seeded global batch, its metrics written as JSON.

Run as a module, once a rank:

    python -m egovlpv2_torch.parallel.mp_worker --pid 0 --nproc 2 \\
        --init file:///tmp/run/rendezvous --steps 3 --global_batch 8 \\
        --out /tmp/run/result_0.json

`launch_workers` starts the ranks as child processes, gives each a time
limit and ends the others when one fails or hangs; `run` is one rank's
work, which a caller without a process group runs in its own process as
the one-process reference. `tests/test_torch_parallel.py` holds two ranks
against one process on the same global batch. With --nproc 1 no group is
started.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_ranks(commands, timeout: float, env=None, cwd=None):
    """Runs one child a command, all at once, and returns (return codes,
    outputs: stdout and stderr together). A child still running after
    `timeout` seconds, or once another child has failed (its ranks would
    wait for it in a collective), is killed; its return code is then
    negative."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    lines = [[] for _ in procs]
    # a thread a child drains its pipe, so a chatty child cannot block
    readers = [threading.Thread(target=lambda p=p, out=out: out.extend(p.stdout),
                                daemon=True)
               for p, out in zip(procs, lines)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in readers:
            t.join()
    return [p.returncode for p in procs], ["".join(out) for out in lines]


def launch_workers(nproc: int, out_dir: str, timeout: float = 300.0,
                   **flags) -> list:
    """Runs `nproc` ranks of this module over a `file://` rendezvous in
    `out_dir` and returns their result dicts in rank order. `flags` are
    this module's flags without the dashes (`steps=3`, `task="epic"`,
    `dropout=True`, ...). Raises RuntimeError with every rank's output if a
    rank fails or runs past `timeout` seconds."""
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    extra = []
    for key, value in flags.items():
        if value is True:
            extra.append(f"--{key}")
        elif value not in (None, False):
            extra += [f"--{key}", str(value)]
    outs = [os.path.join(out_dir, f"result_{pid}.json")
            for pid in range(nproc)]
    commands = [[sys.executable, "-m", "egovlpv2_torch.parallel.mp_worker",
                 "--pid", str(pid), "--nproc", str(nproc), "--init", init,
                 "--out", outs[pid], *extra] for pid in range(nproc)]
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    codes, logs = run_ranks(commands, timeout, env=env, cwd=_repo_root())
    if any(code != 0 for code in codes):
        raise RuntimeError(f"mp_worker ranks ended with {codes} (a negative "
                           f"code: killed after a failure or {timeout} s):\n"
                           + "\n---\n".join(logs))
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _config(task: str, dropout: bool):
    from egovlpv2_torch.cli import dual_config
    from egovlpv2_torch.core.config import replace
    from egovlpv2_torch.tasks.pretrain import tiny_train_config

    cfg = tiny_train_config()
    model = cfg.model
    if not dropout:
        model = replace(model,
                        text=replace(model.text, hidden_dropout=0.0,
                                     attn_dropout=0.0),
                        video=replace(model.video, drop_rate=0.0,
                                      drop_path_rate=0.0))
    # lr high enough that three steps move the parameters; eps as the
    # parity tests of one process have it
    cfg = replace(cfg, model=model, log_grad_norm=True,
                  optim=replace(cfg.optim, lr=1e-3, max_steps=6,
                                warmup_frac=0.34, eps=1e-6))
    if task != "pretrain":
        cfg = dual_config(cfg, task)
    return cfg


def global_batch(cfg, task: str, global_batch_size: int, step: int,
                 seed: int = 1000) -> dict:
    """The global batch of `step`, drawn from `seed + step`: the pretrain
    batch of `tasks.pretrain.synthetic_batch`; for a dual fine-tune its
    video and text and, for EK-100, per-row relevancy weights in
    [0.5, 1)."""
    import numpy as np

    from egovlpv2_torch.tasks.pretrain import synthetic_batch

    rng = np.random.default_rng(seed + step)
    batch = synthetic_batch(cfg, global_batch_size, rng)
    if task == "pretrain":
        return batch
    out = {k: batch[k] for k in ("video", "text_ids", "text_mask")}
    if task == "epic":
        out["relevancy"] = (0.5 + 0.5 * rng.random(global_batch_size)
                            ).astype(np.float32)
    return out


def _fixed_mining(path: str):
    """A `mine_itm_indices` that returns the pairs in `path` (video_idx,
    text_idx, labels over the global batch) at every step, as a comparison
    with another implementation, whose draws differ, needs."""
    import numpy as np
    import torch

    from egovlpv2_torch.objectives.itm_mining import ITMIndices

    with np.load(path) as z:
        fixed = [torch.from_numpy(z[k]).long()
                 for k in ("video_idx", "text_idx", "labels")]
    return lambda *a, **k: ITMIndices(*fixed)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("mp_worker")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--init", default=None,
                    help="rendezvous URL (file:// or tcp://); needed when "
                         "--nproc > 1")
    ap.add_argument("--task", default="pretrain",
                    choices=("pretrain", "charades", "epic"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--batch_seed", type=int, default=1000,
                    help="step i's global batch is drawn from seed + i")
    ap.add_argument("--dropout", action="store_true",
                    help="keep the tiny config's dropout (else rates 0)")
    ap.add_argument("--state", default=None,
                    help="a state_dict to start from, in place of the "
                         "seeded init")
    ap.add_argument("--itm_indices", default=None,
                    help=".npz of fixed mined pairs over the global batch")
    ap.add_argument("--ckpt_dir", default=None,
                    help="save the state collectively, restore it into a "
                         "new trainer and compare")
    ap.add_argument("--params_out", default=None,
                    help="rank 0 writes the final parameters here")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """This rank's run under the process group that is up (none: one
    process): `args.steps` training steps on its rows of the seeded global
    batches, then the optional checkpoint round trip. Returns the result:
    each step's metrics, the mined pairs, the first dropout mask drawn, a
    digest of the parameters and the dropout generator's state."""
    import numpy as np
    import torch

    from egovlpv2_torch.models.dropout import Dropout
    from egovlpv2_torch.parallel import distributed, mesh
    from egovlpv2_torch.train import step as step_module

    device = torch.device("cpu")
    cfg = _config(args.task, args.dropout)

    def build():
        if args.task == "pretrain":
            from egovlpv2_torch.tasks.pretrain import build_pretrain
            trainer = build_pretrain(cfg, device=device)
        else:
            from egovlpv2_torch.tasks.retrieval import build_dual
            trainer = build_dual(cfg, device=device)
        if args.state:
            trainer[0].load_state_dict(torch.load(args.state,
                                                  weights_only=True))
        return trainer

    model, optimizer, scheduler, train_step = build()
    mined, masks = [], []
    mine = step_module.mine_itm_indices
    if args.itm_indices:
        mine = _fixed_mining(args.itm_indices)

    def recording(*a, **k):
        idx = mine(*a, **k)
        mined.append([t.tolist() for t in idx])
        return idx

    def record_mask(module, inputs, output):
        # the first mask this rank drew: the zeros dropout made
        if module.training and not masks:
            dropped = (output == 0) & (inputs[0] != 0)
            masks.append(dropped.flatten().int().tolist())

    first = next((m for m in model.modules()
                  if isinstance(m, Dropout) and m.rate > 0), None)
    if first is not None:
        first.register_forward_hook(record_mask)
    original, step_module.mine_itm_indices = \
        step_module.mine_itm_indices, recording
    try:
        metrics = []
        for i in range(args.steps):
            batch = mesh.local_rows(global_batch(cfg, args.task,
                                                 args.global_batch, i,
                                                 args.batch_seed),
                                    args.global_batch)
            out = train_step(batch)
            metrics.append({k: float(v) for k, v in out.items()})
    finally:
        step_module.mine_itm_indices = original
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    result = {"pid": args.pid, "nproc": distributed.world_size(),
              "rank": distributed.rank(), "metrics": metrics,
              "mined": mined, "dropout_mask": masks[0] if masks else None,
              "params_digest": _digest(model),
              "generator": train_step.generator.get_state().tolist()}

    if args.ckpt_dir:
        from egovlpv2_torch.train.checkpoint import (CheckpointManager,
                                                     load_train_state_,
                                                     train_state)

        state = train_state(model, optimizer, scheduler,
                            train_step.generator, args.steps,
                            train_step.mining_generator)
        manager = CheckpointManager(args.ckpt_dir)
        if distributed.is_main_process():
            manager.save(args.steps, state)
        distributed.barrier("ckpt_saved")
        again = build()
        step = load_train_state_(manager.restore(), *again[:3],
                                 again[3].generator,
                                 again[3].mining_generator)
        same = step == args.steps and _digest(again[0]) == \
            result["params_digest"]
        for a, b in ((train_step.generator, again[3].generator),
                     (train_step.mining_generator,
                      again[3].mining_generator)):
            if a is not None:
                same = same and torch.equal(a.get_state(), b.get_state())
        result["ckpt_roundtrip"] = bool(same)

    if args.params_out and distributed.is_main_process():
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, args.params_out)
    return result


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from egovlpv2_torch.parallel import distributed

    torch.set_num_threads(2)
    if args.nproc > 1:
        distributed.initialize_multihost(args.init, args.nproc, args.pid,
                                         device="cpu")
    result = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(f"mp_worker rank {result['rank']}/{result['nproc']} ok: "
          f"loss_total {[m['loss_total'] for m in result['metrics']]}",
          flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    main()
