"""Time and profile the PyTorch port's feature-extraction paths on one CUDA
card.

    python3 scripts/profile_torch_extract.py [--paths mq nlq qfvs] \
        [--windows 512] [--qfvs_frames 400] [--out chiprun_out/profile]

At the full width of configs/extract_mq.json (TimeSformer-B/16 + RoBERTa-base,
the last 6 of each fused, projection 4096, bf16, 16 frames: S=3137; weights
from the config's seed), on seeded uint8 frames normalised on the device:

  mq    `egovlpv2_torch.cli extract --synthetic <16 * windows>`: the dual
        video tower over inner batches of 64 windows -> [windows, 4096].
  nlq   `FeatureExtractor.fused_window_features` over the same frames with
        one query: the fused stack -> [windows, 768].
  qfvs  `QFVSExtractor.extract_video` at 5 frames a clip (S=981), inner
        batch 16, two concepts and one oracle prompt: the unfused tower,
        KTS on the host, then the fused blocks once a prompt.

For mq and nlq: every inner batch's milliseconds (the host's time from one
result's arrival to the next, the copy of the next inner batch overlapped
with this one's compute), the median of the warm ones (all but the first two
of a call: the first carries the warm-up, and the second arrives early
because the host ran ahead meanwhile), windows a second and the peak
device memory from the start of the call. For qfvs, where
the host is the bound and a result is collected one inner batch late (so the
last entry of a call is only the drain of a result that is already there):
`extract_video` is called twice, and of the second, warm call each runner
call's total over its inner batches is one inner batch's time, stage 1's one
call and the median of stage 2's calls, one a prompt. Then for every path
one more inner batch of the
same model under torch.profiler, after a warm one: the device time of its
kernels by kind, the number of device events, and the device's busy share
(kernel time over the median warm inner batch). The profiler's op table
goes to <out>/prof_extract_<path>.txt.

The card's name and power limit (nvidia-smi) head the output.
"""

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from egovlpv2_torch import cli  # noqa: E402
from egovlpv2_torch.core.config import load_train_config  # noqa: E402
from egovlpv2_torch.data.tokenizer import Tokenizer  # noqa: E402
from egovlpv2_torch.models.egovlp import EgoVLPv2  # noqa: E402
from egovlpv2_torch.tasks.extract import FeatureExtractor  # noqa: E402
from egovlpv2_torch.tasks.qfvs_extract import (FRAMES_PER_CLIP,  # noqa: E402
                                               QFVSExtractor)
from egovlpv2_torch.weights import random_init_  # noqa: E402
from profile_torch_pretrain import _kind, k9_launches  # noqa: E402

CONFIG = "configs/extract_mq.json"
INNER_BATCH = 64
QFVS_INNER_BATCH = 16
QFVS_CONCEPTS = ("cup", "street")
QFVS_ORACLE = "cup and street"


def _report(path: str, log, per_batch: int, what: str) -> float:
    """Prints the inner batches of one call; returns the median warm ms."""
    ms = [m for _, m in log]
    warm_ms = ms[2:] if len(ms) > 2 else ms[-1:]
    warm = statistics.median(warm_ms)
    print(f"[timing {path}] {what}: inner batches {log[0][0]} ms "
          f"{[round(m, 2) for m in ms]} | median of {len(warm_ms)} warm "
          f"{warm:.2f} ms | {per_batch / warm * 1e3:.2f} a second | peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return warm


def _profile(path: str, fn, warm_ms: float, out_dir: str) -> None:
    """One call of `fn` (an inner batch on tensors already on the card)
    under torch.profiler, after a warm one."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    kinds, events = {}, 0
    for e in table:
        if e.device_type == DeviceType.CUDA:
            kinds[_kind(e.key)] = (kinds.get(_kind(e.key), 0.0)
                                   + e.self_device_time_total / 1e3)
            events += e.count
    kernel_ms = sum(v for k, v in kinds.items() if k != "memcpy")
    split = ", ".join(f"{k} {v:.2f}" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    print(f"[profile {path}] profiled inner batch wall {wall_ms:.2f} ms | "
          f"{events} device events | by kind (ms): {split} | kernels "
          f"{kernel_ms:.2f} ms = busy {100 * kernel_ms / warm_ms:.1f}% of the "
          f"{warm_ms:.2f} ms warm inner batch", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.join(out_dir, f"prof_extract_{path}.txt")
    with open(name, "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=60))
    print(f"[profile {path}] K9: {k9_launches(table)}", flush=True)
    print(f"[profile {path}] op table: {name}", flush=True)


def _model(sets=()):
    cfg = load_train_config(CONFIG, list(sets))
    model = EgoVLPv2(cfg.model, device="cuda").eval()
    random_init_(model, torch.Generator().manual_seed(cfg.seed))
    return cfg, model


def _frames(cfg, n: int) -> np.ndarray:
    v = cfg.model.video
    return np.random.default_rng(cfg.seed).integers(
        0, 256, (n, v.img_size, v.img_size, v.in_chans), dtype=np.uint8)


def run_mq(windows: int, out_dir: str) -> None:
    cfg = load_train_config(CONFIG, [])
    frames = cfg.model.video.num_frames
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as feats:
        res = cli.main(["extract", "--config", CONFIG, "--device", "cuda",
                        "--synthetic", str(windows * frames), "--out", feats,
                        "--inner_batch", str(INNER_BATCH)])
    feats = res["features"]["synthetic"]
    assert feats.shape == (windows, cfg.model.projection_dim)
    assert np.isfinite(feats).all()
    warm = _report("mq", res["inner_batches"], INNER_BATCH,
                   f"{windows} windows of {frames} frames -> {feats.shape}")
    ex = FeatureExtractor(res["model"], INNER_BATCH, device_norm="imagenet")
    batch = torch.from_numpy(_frames(cfg, INNER_BATCH * frames).reshape(
        INNER_BATCH, frames, *_frames(cfg, 1).shape[1:])).cuda()
    _profile("mq", lambda: ex._video_features(batch), warm, out_dir)


def run_nlq(windows: int, out_dir: str) -> None:
    cfg, model = _model()
    frames = cfg.model.video.num_frames
    tok = Tokenizer("roberta-base", max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    enc = tok(["where did I put the scissors"])
    ids, mask = enc["text_ids"][0], enc["text_mask"][0]
    ex = FeatureExtractor(model, INNER_BATCH, device_norm="imagenet")
    torch.cuda.reset_peak_memory_stats()
    feats = ex.fused_window_features(_frames(cfg, windows * frames), frames,
                                     ids, mask)
    assert feats.shape == (windows, cfg.model.video.embed_dim)
    assert np.isfinite(feats).all()
    warm = _report("nlq", ex.batch_log, INNER_BATCH,
                   f"{windows} windows x 1 query -> {feats.shape}")
    batch = torch.from_numpy(_frames(cfg, INNER_BATCH * frames).reshape(
        INNER_BATCH, frames, *_frames(cfg, 1).shape[1:])).cuda()
    ids_b = torch.from_numpy(np.repeat(ids[None], INNER_BATCH, 0)).cuda()
    mask_b = torch.from_numpy(np.repeat(mask[None], INNER_BATCH, 0)).cuda()
    _profile("nlq", lambda: ex._fused_features(batch, ids_b, mask_b), warm,
             out_dir)


def run_qfvs(n_frames: int, out_dir: str) -> None:
    cfg, model = _model([f"model.video.num_frames={FRAMES_PER_CLIP}"])
    tok = Tokenizer("roberta-base", max_len=cfg.max_text_len,
                    vocab_cap=cfg.model.text.vocab_size)
    ex = QFVSExtractor(model, QFVS_INNER_BATCH)
    frames = _frames(cfg, n_frames)
    totals = []
    for _ in range(2):  # the first call carries the warm-up
        del ex.batch_log[:]
        t0 = time.perf_counter()
        out = ex.extract_video(frames, tok, QFVS_CONCEPTS, QFVS_ORACLE)
        totals.append((time.perf_counter() - t0) * 1e3)
    n_clips = out["num_shots"]
    assert all(np.isfinite(f).all() and f.shape == (n_clips, 768)
               for f in out["features"].values())
    n_batches = -(-n_clips // QFVS_INNER_BATCH)  # of every runner call
    print(f"[timing qfvs] {n_frames} frames -> {n_clips} clips, change points "
          f"{out['change_points'].tolist()}, {len(out['features'])} prompts | "
          f"extract_video {totals[0]:.1f} ms the first call, {totals[1]:.1f} "
          f"ms the second", flush=True)
    ms = [m for _, m in ex.batch_log]
    calls = [ms[i:i + n_batches] for i in range(0, len(ms), n_batches)]
    per_batch = [sum(c) / len(c) for c in calls]
    warm1, warm2 = per_batch[0], statistics.median(per_batch[1:])
    shapes = [shape for shape, _ in ex.batch_log]
    for path, what, first, rows, warm in (
            ("qfvs_unfused", "stage 1, the unfused video tower", 0,
             calls[:1], warm1),
            ("qfvs_fused", "stage 2, the fused blocks, a call a prompt",
             n_batches, calls[1:], warm2)):
        print(f"[timing {path}] {what}, second extract_video: inner batches "
              f"{shapes[first]} ms {[[round(m, 2) for m in c] for c in rows]} "
              f"(a call's last entry is the drain) | a call's total over its "
              f"{n_batches} inner batches {warm:.2f} ms"
              f"{' (median of the calls)' if len(rows) > 1 else ''} | "
              f"{QFVS_INNER_BATCH / warm * 1e3:.2f} clips a second", flush=True)
    v = cfg.model.video
    clips = torch.from_numpy(_frames(cfg, QFVS_INNER_BATCH * FRAMES_PER_CLIP)
                             .reshape(QFVS_INNER_BATCH, FRAMES_PER_CLIP,
                                      v.img_size, v.img_size, v.in_chans)).cuda()
    _profile("qfvs_unfused", lambda: model.video_unfused(clips), warm1, out_dir)
    with torch.no_grad():
        tokens = model.video_unfused(clips)
        enc = tok([f"There is a {QFVS_CONCEPTS[0]}"])
        t = model.text_unfused(torch.from_numpy(enc["text_ids"]).cuda(),
                               torch.from_numpy(enc["text_mask"]).cuda())
    m = torch.from_numpy(enc["text_mask"]).cuda()
    _profile("qfvs_fused", lambda: ex._fuse(tokens, t, m), warm2, out_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--paths", nargs="+", default=["mq", "nlq", "qfvs"],
                   choices=["mq", "nlq", "qfvs"])
    p.add_argument("--windows", type=int, default=512)
    p.add_argument("--qfvs_frames", type=int, default=400)
    p.add_argument("--out", default="chiprun_out/profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_extract: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path in args.paths:
        {"mq": lambda: run_mq(args.windows, args.out),
         "nlq": lambda: run_nlq(args.windows, args.out),
         "qfvs": lambda: run_qfvs(args.qfvs_frames, args.out)}[path]()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
