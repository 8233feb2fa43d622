"""Device time of the fused attention kernel (K9) a call, on one CUDA card.

    python3 scripts/profile_torch_flash.py [--calls 30] [--runs 1152 3200]
        [--ring_rows 128 512] [--chunked] [--only t2i] [--dtypes float32]

`chip_smoke.py` times a wrapper call with CUDA events, and below about 0.2 ms
that reads the host's time to issue the call, not the kernel's. This script
reads the kernel's own time from torch.profiler: for each shape the models
give `flash_attention` (H=12, Dh=64; q, k and v transposed views of
[B, S, H*Dh] projections; a padding mask where the models have one), bf16 and
f32, the mean device time a call over `--calls` calls after 3 warm ones
(and the host's time a call of `flash_attention`, before it waits for the
card), summed over the call's kernels (the few-query form's split kernel and its
merge), each kernel's own time and name, the geometry of
`flash_fwd_geometry` (form, run, splits) where the tree has one, and the
device time of one `scaled_dot_product_attention` call on contiguous copies
of the same inputs (the library call of `chip_smoke.py`) and on the views
themselves, the plain version's (`attend_plain`) and the call's bound (bytes
or operations, as `chip_smoke.py` counts them).

`--runs` also times the few-query shapes at each run of keys given (a
multiple of the form's chunk, 128 in bf16 and 64 in float32; Sk rounded up
to one is a single split), the geometry's other fields as
`flash_fwd_geometry` gives them: the sweep the geometry's choice of run
comes from. `--ring_rows` does the same for the bf16 ring form (i2t over
at most 64 keys): each run of query rows a block given (a multiple of 16),
and `--chunked` times the chunked many-query form at those shapes too (the
one the ring form replaced there), all on the same inputs. The sweeps call the C entry
point themselves, since the wrapper launches only the geometry's own
choice. `--only` keeps the cases of one label, `--dtypes` the dtypes
named.

The package is imported from the current directory when it holds one, so that
two trees can be compared inside one call: run the script of this tree from
the root of each (parent, change, change, parent). The card's name and power
limit (nvidia-smi) head the output.
"""

import argparse
import os
import subprocess
import sys
import time
from types import SimpleNamespace

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.getcwd() if os.path.isdir("egovlpv2_torch") else here)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.nn import functional as F  # noqa: E402

from egovlpv2_torch.ops import _kernels, flash  # noqa: E402
from egovlpv2_torch.ops.attention import (attend_plain,  # noqa: E402
                                          make_additive_mask)
# after the package: it then uses the tree just imported, not its own
from profile_torch_pretrain import K9_KERNELS  # noqa: E402

# K9's kernels in this tree and, so that an older tree is measured too, the
# single float32 kernel it had before the 3xTF32 forms
KERNELS = (*K9_KERNELS, "fused_attention_fwd_kernel")
H, DH = 12, 64
# The card's published peaks (NVIDIA H100 SXM data sheet, dense), as
# chip_smoke.py has them.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (label, B, Sq, Sk, masked)
CASES = (
    ("i2t", 64, 3137, 15, True), ("i2t", 20, 3137, 15, True),
    ("i2t", 16, 981, 15, True), ("i2t", 16, 785, 15, True),
    ("t2i", 64, 15, 3137, False), ("t2i", 20, 15, 3137, False),
    ("t2i", 16, 15, 981, False), ("t2i", 16, 15, 785, False),
    ("t2i", 5, 15, 3137, False),  # EgoMCQ 16f, one question: 3 splits
    ("text self", 64, 15, 15, True), ("text self", 8, 30, 30, True),
    ("above 32", 16, 197, 197, False), ("above 32", 16, 64, 64, True),
    # the EgoTaskQA step's i2t and its evaluation's t2i and text (f32)
    ("i2t", 8, 785, 15, True), ("t2i", 8, 15, 785, False),
    ("text self", 8, 15, 15, True),
)


def _launch(q, k, v, bias, out, geo, scale) -> None:
    """One K9 launch at `geo`, through the C entry point, as the wrapper
    makes it (bias: float32 [B or 1, 1, 1, Sk])."""
    b, h, sq, dh = q.shape
    partials = _kernels.flash_fwd_scratch(q, geo)
    strides = [x for t in (q, k, v, out) for x in _kernels.attention_strides(t)]
    code = _kernels.load().fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        _kernels._DTYPE_CODES[q.dtype], b, h, sq, k.shape[2], dh, *strides,
        0 if bias is None or bias.shape[0] == 1 else bias.stride(0), 0,
        float(scale), _kernels._FLASH_FORMS[geo.form], geo.run or 0,
        geo.splits, geo.row_tiles or 0, geo.stages or 0,
        geo.shared_bytes or 0, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"fused_attention_fwd: CUDA error {code}")


def _ring_sweep(geo, sq: int, rows: int):
    """The ring form's geometry at `rows` query rows a block, the other
    fields as `flash_fwd_geometry` gives them."""
    return SimpleNamespace(**{**vars(geo), "run": rows,
                              "splits": -(-sq // rows)})


def _bound_us(dtype, b: int, sq: int, sk: int, masked: bool) -> float:
    """The least time of a call, as `chip_smoke.flash_bound_ms` counts it:
    q, k, v and the float32 mask read once, the output written once, or
    4 Sq Sk Dh operations a (batch, head) at the dtype's peak, the larger."""
    e = torch.finfo(dtype).bits // 8
    t_bytes = ((2 * sq + 2 * sk) * b * H * DH * e + masked * b * sk * 4) \
        / PEAK_BYTES_S
    return max(t_bytes, 4 * b * H * sq * sk * DH / PEAK_FLOPS[dtype]) * 1e6


def _per_call(fn, calls: int) -> dict:
    """kernel name -> its device time a call, us, over `calls` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def _host_us(fn, calls: int) -> float:
    """The host's time a call of `fn`, us, over `calls` calls after 3 warm
    ones, before it waits for the card (as chip_smoke.py's `_window_ms`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return host


def _line(tree, dtype, label, b, sq, sk, events, what) -> str:
    total = sum(events.values())
    own = ", ".join(f"{key[:48]} {t:.1f}" for key, t in sorted(events.items()))
    return (f"[k9 {tree}] {str(dtype).split('.')[-1]:8s} {label:9s} B={b} "
            f"Sq={sq} Sk={sk}: {total:.1f} us a call{what}  [{own}]")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--runs", type=int, nargs="*", default=[])
    p.add_argument("--ring_rows", type=int, nargs="*", default=[])
    p.add_argument("--chunked", action="store_true")
    p.add_argument("--only", default=None)
    p.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"],
                   choices=["bfloat16", "float32"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flash: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    root = os.path.abspath(flash.__file__)
    for _ in range(3):  # <root>/egovlpv2_torch/ops/flash.py
        root = os.path.dirname(root)
    tree = os.path.basename(root)
    geometry = getattr(_kernels, "flash_fwd_geometry", None)  # not in older trees
    gen = torch.Generator(device="cuda").manual_seed(0)

    def heads(b, s, dtype):
        return torch.randn((b, s, H, DH), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)

    for dtype in (getattr(torch, d) for d in args.dtypes):
        for label, b, sq, sk, masked in CASES:
            if args.only not in (None, label):
                continue
            q, k, v = heads(b, sq, dtype), heads(b, sk, dtype), heads(b, sk, dtype)
            bias = None
            if masked:
                mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
                mask[:, 0] = True
                bias = make_additive_mask(mask.long())
            call = lambda: flash.flash_attention(q, k, v, scale=DH ** -0.5,
                                                 bias=bias)
            events = _per_call(call, args.calls)
            host = _host_us(call, args.calls)
            events = {key: t for key, t in events.items()
                      if any(n in key for n in KERNELS)}
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            lib_mask = None if bias is None else bias.to(dtype)
            lib = sum(_per_call(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=lib_mask, scale=DH ** -0.5),
                args.calls).values())
            lib_views = sum(_per_call(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=DH ** -0.5),
                args.calls).values())
            plain = sum(_per_call(lambda: attend_plain(
                q, k, v, scale=DH ** -0.5, bias=bias), args.calls).values())
            what = (f" (library {lib:.1f} us, on the views {lib_views:.1f}; "
                    f"plain {plain:.1f} us; bound "
                    f"{_bound_us(dtype, b, sq, sk, masked):.1f} us; the host "
                    f"{host:.1f} us a call)")
            if geometry is not None:
                geo = geometry(dtype, DH, sq, sk, b, H)
                what += (f" ({geo.form}, run {geo.run}, {geo.splits} splits, "
                         f"{getattr(geo, 'stages', None)} stages)")
            print(_line(tree, dtype, label, b, sq, sk, events, what), flush=True)
            if geometry is not None and geo.form == "many_queries" \
                    and getattr(geo, "key_tiles", None):
                sweeps = [(f"ring: {rows} rows a block",
                           _ring_sweep(geo, sq, rows))
                          for rows in args.ring_rows]
                if args.chunked:
                    sweeps.append(("the chunked form", SimpleNamespace(
                        form="many_queries_chunked", run=None, splits=1,
                        row_tiles=None, stages=None, shared_bytes=None)))
                for what, other in sweeps:
                    out = torch.empty_like(q)
                    swept = _per_call(lambda: _launch(q, k, v, bias, out, other,
                                                      DH ** -0.5), args.calls)
                    print(_line(tree, dtype, label, b, sq, sk, swept,
                                f" (sweep: {what})"), flush=True)
            if geometry is None or not geometry(
                    dtype, DH, sq, sk, b, H).form.startswith("few_queries"):
                continue
            for run in args.runs:
                geo = geometry(dtype, DH, sq, sk, b, H)
                geo.run, geo.splits = run, -(-sk // run)
                out = torch.empty_like(q)
                swept = _per_call(lambda: _launch(q, k, v, bias, out, geo,
                                                  DH ** -0.5), args.calls)
                print(_line(tree, dtype, label, b, sq, sk, swept,
                            f" (sweep: run {run}, {geo.splits} splits)"),
                      flush=True)

if __name__ == "__main__":
    main()
