"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each source is compiled with `nvcc` for `sm_90a` into a shared library of
its own with a plain C interface, named by a hash of the sources and flags,
under `build/egovlpv2_torch/` of the checkout, at first CUDA use; the
compilers of all sources run side by side. The libraries are loaded with
`ctypes`. Each wrapper checks its tensors, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry of `launch_counts`.

Nothing here runs at import: the CPU tests import this module on machines
without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HEADERS = ("attention_common.cuh",)
# source -> the C functions it exports
_SOURCES = {
    "divided_attention.cu": (
        "space_attention_fwd", "time_attention_fwd", "cls_row_attention_fwd",
        "cuda_error_string"),
    "divided_attention_bwd.cu": (
        "space_attention_bwd", "time_attention_bwd", "cls_row_attention_bwd",
        "attention_bwd_parts"),
    "time_attention.cu": ("time_attention_fwd_tc",),
    "layernorm.cu": ("layernorm_fwd", "layernorm_bwd"),
    "fused_attention.cu": ("fused_attention_fwd",),
    "divided_attention_general.cu": (
        "general_attention_fwd", "general_attention_bwd"),
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egovlpv2_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last reset, counted where they launch.
launch_counts = {"space_attention_fwd": 0, "time_attention_fwd": 0,
                 "cls_row_attention_fwd": 0, "space_attention_bwd": 0,
                 "time_attention_bwd": 0, "cls_row_attention_bwd": 0,
                 "layernorm_fwd": 0, "layernorm_bwd": 0,
                 "fused_attention_fwd": 0,
                 "divided_attention_general_fwd": 0,
                 "divided_attention_general_bwd": 0}


# K9's launches since the last reset by the form `flash_fwd_geometry` named.
flash_form_counts = {"many_queries": 0, "few_queries": 0,
                     "many_queries_tf32": 0, "few_queries_tf32": 0}


# K8's launches since the last reset by the rows of x.
layernorm_bwd_rows: dict = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, flash_form_counts):
        for name in counts:
            counts[name] = 0
    layernorm_bwd_rows.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels of egovlpv2_torch cannot be built")
    return path


def library_paths() -> dict:
    """source name -> where its library for the current sources and flags
    lives."""
    shared = b"".join((_CSRC / h).read_bytes() for h in _HEADERS) \
        + " ".join(NVCC_FLAGS).encode()
    out = {}
    for source in _SOURCES:
        digest = hashlib.sha256((_CSRC / source).read_bytes()
                                + shared).hexdigest()[:16]
        out[source] = BUILD_DIR / f"{Path(source).stem}_{digest}.so"
    return out


def build() -> dict:
    """Compile every source whose library is missing, all at once."""
    libs = library_paths()
    procs = []
    for source, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source)]
        procs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for cmd, tmp, lib, proc in procs:  # wait for all before raising
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{output}")
        else:
            os.replace(tmp, lib)  # atomic: no one loads half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def load() -> SimpleNamespace:
    """Build (if needed) and load the kernels' libraries, once a process.
    Returns the C functions by name."""
    fns = SimpleNamespace()
    for source, lib in build().items():
        cdll = ctypes.CDLL(str(lib))
        for name in _SOURCES[source]:
            setattr(fns, name, getattr(cdll, name))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_int64
    fns.space_attention_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [f32, ptr]
    fns.space_attention_fwd.restype = i32
    fns.time_attention_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [f32] \
        + [i32] * 2 + [ptr]
    fns.time_attention_fwd.restype = i32
    fns.time_attention_fwd_tc.argtypes = [ptr, ptr] + [i32] * 6 + [f32] \
        + [i32] * 3 + [ptr]
    fns.time_attention_fwd_tc.restype = i32
    fns.cls_row_attention_fwd.argtypes = [ptr] * 4 + [i32] * 7 + [f32, ptr]
    fns.cls_row_attention_fwd.restype = i32
    fns.space_attention_bwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
    fns.space_attention_bwd.restype = i32
    fns.time_attention_bwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32] \
        + [i32] * 4 + [ptr]
    fns.time_attention_bwd.restype = i32
    fns.cls_row_attention_bwd.argtypes = [ptr] * 6 + [i32, ptr] + [i32] * 7 \
        + [f32, ptr]
    fns.cls_row_attention_bwd.restype = i32
    fns.attention_bwd_parts.argtypes = [i32, i32, i32, i32]
    fns.attention_bwd_parts.restype = i32
    fns.layernorm_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]
    fns.layernorm_fwd.restype = i32
    fns.layernorm_bwd.argtypes = [ptr] * 7 + [i32, i32, f32] + [i32] * 3 \
        + [ptr]
    fns.layernorm_bwd.restype = i32
    fns.fused_attention_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [i64] * 14 \
        + [f32] + [i32] * 6 + [ptr]
    fns.fused_attention_fwd.restype = i32
    fns.general_attention_fwd.argtypes = [ptr] * 4 + [i32] * 7 + [f32] \
        + [ptr] * 2 + [i32] * 8 + [ptr]
    fns.general_attention_fwd.restype = i32
    fns.general_attention_bwd.argtypes = [ptr] * 7 + [i32] * 7 + [f32] \
        + [ptr] * 4 + [i32] * 11 + [ptr]
    fns.general_attention_bwd.restype = i32
    fns.cuda_error_string.argtypes = [i32]
    fns.cuda_error_string.restype = ctypes.c_char_p
    return fns


def _check(qkv: torch.Tensor, out: torch.Tensor, num_heads: int,
           num_frames: int) -> tuple:
    if qkv.device.type != "cuda" or out.device != qkv.device:
        raise ValueError(f"kernel needs qkv and out on one CUDA device, got "
                         f"{qkv.device} and {out.device}")
    if qkv.dtype not in _DTYPE_CODES or out.dtype != qkv.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv.dtype} "
                        f"and {out.dtype}")
    if qkv.dim() != 3 or out.dim() != 3:
        raise ValueError("kernel takes qkv [B, S, 3*H*Dh] and out [B, S, H*Dh]")
    b, s, w3 = qkv.shape
    if w3 % (3 * num_heads):
        raise ValueError(f"qkv width {w3} is not 3 * {num_heads} heads * Dh")
    dh = w3 // (3 * num_heads)
    if dh % 8 or dh > 128:
        raise ValueError(f"head dim {dh} must be a multiple of 8 and <= 128")
    if tuple(out.shape) != (b, s, num_heads * dh):
        raise ValueError(f"out {tuple(out.shape)} != {(b, s, num_heads * dh)}")
    if s < 2 or (s - 1) % num_frames:
        raise ValueError(f"S={s} is not 1 + {num_frames} frames * N patches")
    if not (qkv.is_contiguous() and out.is_contiguous()):
        raise ValueError("kernel needs contiguous qkv and out")
    if qkv.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("kernel needs 16-byte aligned qkv and out")
    return b, s, dh


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        msg = load().cuda_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def space_attention_fwd(qkv: torch.Tensor, out: torch.Tensor, *,
                        num_heads: int, num_frames: int, scale: float) -> None:
    """K1: rows 1..S-1 of divided SPACE attention, written into `out`.

    qkv [B, S, 3*H*Dh] (the qkv Linear output), out [B, S, H*Dh]."""
    name = "space_attention_fwd"
    b, s, dh = _check(qkv, out, num_heads, num_frames)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().space_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s,
            num_heads, dh, num_frames, float(scale), stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# K2's tensor-core form (`csrc/time_attention.cu`): a block is one warp that
# takes ceil(TIME_FWD_ROWS / F) patch columns of one (b, h) one after
# another in one buffer; on an H100 the fastest of the geometries PERF.md
# records at F = 4, 5, 16 and 32, and faster than the grouped form at each.
TIME_FWD_ROWS = 16  # a block's columns hold at least this many query rows
TIME_FWD_MAX_F = 63  # F + 1 keys in at most four 16-row tiles
_TIME_FWD_PAD = 8  # bf16 of padding a staged row


def time_fwd_geometry(dtype: torch.dtype, dh: int, s: int,
                      num_frames: int) -> SimpleNamespace:
    """K2's launch geometry for qkv of `dtype` at head dim `dh` and
    S = 1 + num_frames * N:
      * `form`: "tensor_cores" for bf16 with `dh` a multiple of 16 up to 64
        and F <= TIME_FWD_MAX_F, else "grouped" (the CUDA-core form,
        kThreads / G patch rows a block);
      * `rows`: patch rows a block in column-major order (row f * N + n of
        the patch rows is entry n * F + f): whole columns, `cols` of them,
        in the tensor-core form;
      * `parts`: blocks a (batch, head), ceil((S - 1) / rows);
      * `cols` (tensor-core form, else None): patch columns a block of one
        warp, ceil(TIME_FWD_ROWS / F), so that the rows it stages once, the
        CLS key and the zeros past F, are shared by at least 16 query rows;
      * `key_tiles`, `query_tiles`: the 16-row MMA tiles of a column's
        F + 1 keys and F queries (tensor-core form);
      * `shared_bytes`: a tensor-core block's dynamic shared memory, one
        buffer of K and V (16 * key_tiles rows) and Q (16 * query_tiles
        rows) at a pitch of dh + 8 bf16; None in the grouped form, which
        has none.
    Pure, and the one place this geometry is decided: the CPU tests check
    it, and each C entry point launches with it as given, refusing any
    other (CUDA error 1, invalid argument)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dh < 8 or dh % 8 or dh > 128:
        raise ValueError(f"head dim {dh} must be a multiple of 8 and <= 128")
    if num_frames < 1 or s < 2 or (s - 1) % num_frames:
        raise ValueError(f"S={s} is not 1 + {num_frames} frames * N patches")
    f, n = num_frames, (s - 1) // num_frames
    if not (dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 64
            and f <= TIME_FWD_MAX_F):
        rows = 256 // cls_row_geometry(dtype, dh, s).group  # kThreads / G
        return SimpleNamespace(form="grouped", rows=rows,
                               parts=-(-(s - 1) // rows), cols=None,
                               key_tiles=None, query_tiles=None,
                               shared_bytes=None)
    kt, qt = (f + 16) // 16, (f + 15) // 16
    cols = -(-TIME_FWD_ROWS // f)
    return SimpleNamespace(form="tensor_cores", rows=cols * f,
                           parts=-(-n // cols), cols=cols, key_tiles=kt,
                           query_tiles=qt, shared_bytes=2 * (
                               2 * 16 * kt + 16 * qt) * (dh + _TIME_FWD_PAD))


def time_attention_fwd(qkv: torch.Tensor, out: torch.Tensor, *,
                       num_heads: int, num_frames: int, scale: float) -> None:
    """K2: rows 1..S-1 of divided TIME attention, written into `out`, in the
    form `time_fwd_geometry` names: one `__global__` launch either way."""
    name = "time_attention_fwd"
    b, s, dh = _check(qkv, out, num_heads, num_frames)
    geo = time_fwd_geometry(qkv.dtype, dh, s, num_frames)
    if geo.form == "tensor_cores":
        fn, extra = load().time_attention_fwd_tc, (
            geo.cols, geo.parts, geo.shared_bytes)
    else:
        fn, extra = load().time_attention_fwd, (geo.rows, geo.parts)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s,
                  num_heads, dh, num_frames, float(scale), *extra, stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# K3/K6's first launch: threads a block, 8 head-dim elements a lane.
CLS_ROW_THREADS = 256
CLS_ROW_MAX_DH = 128  # the widest head dim they are built for: 16 lanes a key


def cls_row_geometry(dtype: torch.dtype, dh: int, s: int) -> SimpleNamespace:
    """K3's and K6's launch geometry for qkv of `dtype` at head dim `dh`
    over S keys (the CLS query's):
      * `group`: lanes a key, Dh/8 rounded up to a power of two (each lane
        holds 8 elements of the head dim);
      * `keys`: keys a row group takes in a block, 4 (`kClsKeys` of
        `csrc/attention_common.cuh`, compiled in). K3 issues all their k
        and v loads at once, K6 in two batches;
      * `run`: keys a block, keys * CLS_ROW_THREADS / group (128 at
        Dh=64); a block's key c of row group i is key
        part * run + i + c * (CLS_ROW_THREADS / group);
      * `parts`: blocks a (batch, head), ceil(S / run); the parts axis of
        K3's f32 partials [B, H, parts, Dh + 2] and of K6's f32 scratch
        [B, H, parts, 3, Dh].
    Pure, and the one place this geometry is decided: the CPU tests check
    it, and the C entry points launch with it as given, refusing any
    other (CUDA error 1, invalid argument)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dh < 8 or dh % 8 or dh > CLS_ROW_MAX_DH:
        raise ValueError(f"head dim {dh} must be a multiple of 8 and <= "
                         f"{CLS_ROW_MAX_DH}")
    if s < 1:
        raise ValueError(f"S={s} must be >= 1")
    group = 1
    while group * 8 < dh:
        group *= 2
    keys = 4
    run = keys * CLS_ROW_THREADS // group
    return SimpleNamespace(group=group, keys=keys, run=run,
                           parts=-(-s // run))


def cls_row_attention_fwd(qkv: torch.Tensor, out: torch.Tensor,
                          lse: torch.Tensor, *, num_heads: int,
                          scale: float) -> None:
    """K3: row 0 (the CLS query over all S keys), written into `out`, and
    its log-sum-exp of the logits scale * q0.k (natural log) into `lse`,
    f32 [B, H] contiguous, which K6 reads. Two `__global__` launches on
    `cls_row_geometry`: the partials of each run of keys into f32 scratch
    allocated here, then their merge in a fixed order."""
    name = "cls_row_attention_fwd"
    b, s, dh = _check(qkv, out, num_heads, 1)
    _check_scratch("lse", lse, (b, num_heads), qkv.device)
    geo = cls_row_geometry(qkv.dtype, dh, s)
    partials = torch.empty((b, num_heads, geo.parts, dh + 2),
                           dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().cls_row_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
            partials.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s, num_heads, dh,
            geo.run, geo.parts, float(scale), stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# ---------------- backward ----------------


def _check_bwd(qkv: torch.Tensor, g: torch.Tensor, dqkv: torch.Tensor,
               num_heads: int, num_frames: int) -> tuple:
    b, s, dh = _check(qkv, g, num_heads, num_frames)
    if dqkv.device != qkv.device or dqkv.dtype != qkv.dtype \
            or dqkv.shape != qkv.shape:
        raise ValueError(f"dqkv must match qkv ({tuple(qkv.shape)}, "
                         f"{qkv.dtype}, {qkv.device}), got "
                         f"{tuple(dqkv.shape)}, {dqkv.dtype}, {dqkv.device}")
    if not dqkv.is_contiguous() or dqkv.data_ptr() % 16:
        raise ValueError("kernel needs a contiguous, 16-byte aligned dqkv")
    return b, s, dh


def _check_scratch(name: str, t: torch.Tensor, shape: tuple,
                   device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} {t.device}")


# K5's tensor-core form (`csrc/divided_attention_bwd.cu`, time_bwd_kernel):
# one warp a block, each block TIME_BWD_COLS patch columns of one (b, h).
TIME_BWD_COLS = 4
TIME_BWD_MAX_F = 63  # F + 1 keys in at most four 16-row tiles
_TIME_BWD_PAD = 8  # bf16 of padding a staged row


def time_bwd_geometry(dtype: torch.dtype, dh: int, s: int,
                      num_frames: int) -> SimpleNamespace:
    """K5's launch geometry for qkv of `dtype` at head dim `dh` and
    S = 1 + num_frames * N:
      * `form`: "tensor_cores" for bf16 with `dh` a multiple of 16 up to 64
        and F <= TIME_BWD_MAX_F (a warp a block; faster than the grouped
        form at every frame count the paths have, 4 included: PERF.md
        section 6); else "grouped" (the CUDA-core query and key passes,
        `kThreads` / G patch rows a block);
      * `rows`: patch rows a block, in column-major order (row f * N + n of
        the patch rows is entry n * F + f): whole columns, `cols` of them,
        in the tensor-core form;
      * `cols`: patch columns a block in the tensor-core form, else None;
      * `parts`: blocks a (batch, head), ceil((S - 1) / rows); the parts
        axis of the f32 `cls_part` [B, H, parts, 2, Dh];
      * `shared_bytes`: a tensor-core block's dynamic shared memory: K and
        V (16 * key_tiles rows) and Q and G (16 * query_tiles rows) at a
        pitch of dh + 8 bf16, P and dS (16 * query_tiles rows) at
        16 * key_tiles + 8, and the f32 [2, dh] sum of the CLS key's dk and
        dv; the grouped form's static 16 KB;
      * `key_tiles`, `query_tiles`: the 16-row MMA tiles of a column's F + 1
        keys and F queries (tensor-core form).
    Pure, and the one place this geometry is decided: the CPU tests check
    it, and the C entry point launches with it as given, refusing any other
    (CUDA error 1, invalid argument)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if dh < 8 or dh % 8 or dh > 128:
        raise ValueError(f"head dim {dh} must be a multiple of 8 and <= 128")
    if num_frames < 1 or s < 2 or (s - 1) % num_frames:
        raise ValueError(f"S={s} is not 1 + {num_frames} frames * N patches")
    f, n = num_frames, (s - 1) // num_frames
    if dtype == torch.bfloat16 and dh % 16 == 0 and dh <= 64 \
            and f <= TIME_BWD_MAX_F:
        kt, qt = (f + 16) // 16, (f + 15) // 16
        kp, qp, ld = 16 * kt, 16 * qt, dh + _TIME_BWD_PAD
        shared = 2 * ((2 * kp + 2 * qp) * ld + 2 * qp * (kp + _TIME_BWD_PAD)) \
            + 2 * dh * 4
        cols = TIME_BWD_COLS
        return SimpleNamespace(form="tensor_cores", rows=cols * f, cols=cols,
                               parts=-(-n // cols), shared_bytes=shared,
                               key_tiles=kt, query_tiles=qt)
    # kThreads (256) of csrc/attention_common.cuh, G lanes (8 elements each)
    # a row; sm_part [2][kThreads / G][8 G] f32
    rows = 256 // cls_row_geometry(dtype, dh, s).group
    return SimpleNamespace(form="grouped", rows=rows, cols=None,
                           parts=-(-(s - 1) // rows),
                           shared_bytes=2 * 256 * 8 * 4, key_tiles=None,
                           query_tiles=None)


def attention_bwd_scratch(qkv: torch.Tensor, *, num_heads: int,
                          num_frames: int, axis: str) -> tuple:
    """The f32 scratch of one backward on `axis` ("space" or "time"):
    `stats` [2, B, H, S] (each patch row's log-sum-exp and delta, which K4
    and K5's grouped form pass between their launches) and `cls_part`
    [B, H, parts, 2, Dh] (the blocks' shares of the CLS key's dk and dv).
    Uninitialised: the backward fills what it uses. On the time axis a
    meta qkv gives the shapes without building the kernels."""
    if qkv.device.type not in ("cuda", "meta"):
        raise ValueError(f"kernel scratch needs a CUDA qkv, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv.dtype}")
    b, s, w3 = qkv.shape
    dh = w3 // (3 * num_heads)
    if axis == "time":
        parts = time_bwd_geometry(qkv.dtype, dh, s, num_frames).parts
    else:
        parts = load().attention_bwd_parts(_DTYPE_CODES[qkv.dtype], s, dh,
                                           num_frames)
    stats = torch.empty((2, b, num_heads, s), dtype=torch.float32,
                        device=qkv.device)
    cls_part = torch.empty((b, num_heads, parts, 2, dh), dtype=torch.float32,
                           device=qkv.device)
    return stats, cls_part


def _launch_bwd(name: str, qkv, g, dqkv, stats, cls_part, shape: tuple,
                parts: int, *geometry, num_heads, num_frames, scale):
    b, s, dh = shape
    _check_scratch("stats", stats, (2, b, num_heads, s), qkv.device)
    _check_scratch("cls_part", cls_part, (b, num_heads, parts, 2, dh),
                   qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = getattr(load(), name)(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            cls_part.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s, num_heads, dh,
            num_frames, float(scale), *geometry, stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


def space_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                        dqkv: torch.Tensor, stats: torch.Tensor,
                        cls_part: torch.Tensor, *, num_heads: int,
                        num_frames: int, scale: float) -> None:
    """K4: backward of K1. From qkv [B, S, 3*H*Dh] and the cotangent
    g [B, S, H*Dh] of the output, writes rows 1..S-1 of dq, dk and dv into
    dqkv (the layout of qkv), and the scratch of `attention_bwd_scratch`.
    Row 0 of dqkv is left to `cls_row_attention_bwd`."""
    b, s, dh = _check_bwd(qkv, g, dqkv, num_heads, num_frames)
    parts = load().attention_bwd_parts(_DTYPE_CODES[qkv.dtype], s, dh,
                                       num_frames)
    _launch_bwd("space_attention_bwd", qkv, g, dqkv, stats, cls_part,
                (b, s, dh), parts, num_heads=num_heads,
                num_frames=num_frames, scale=scale)


def time_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                       dqkv: torch.Tensor, stats: torch.Tensor,
                       cls_part: torch.Tensor, *, num_heads: int,
                       num_frames: int, scale: float) -> None:
    """K5: backward of K2; arguments as `space_attention_bwd`. Runs the form
    `time_bwd_geometry` names: the tensor-core form (one `__global__`
    launch, which leaves `stats` unwritten) or the two grouped passes."""
    b, s, dh = _check_bwd(qkv, g, dqkv, num_heads, num_frames)
    geo = time_bwd_geometry(qkv.dtype, dh, s, num_frames)
    tensor_cores = geo.form == "tensor_cores"
    _launch_bwd("time_attention_bwd", qkv, g, dqkv, stats, cls_part,
                (b, s, dh), geo.parts, int(tensor_cores), geo.cols or 0,
                geo.parts, geo.shared_bytes if tensor_cores else 0,
                num_heads=num_heads, num_frames=num_frames, scale=scale)


def cls_row_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          dqkv: torch.Tensor, cls_part: torch.Tensor, *,
                          num_heads: int, scale: float) -> None:
    """K6: backward of K3, after K4 or K5 on the same stream, from K3's
    output `out` (row 0 read) and `lse` [B, H]: writes row 0 of dq, adds
    the CLS query's share to rows 1..S-1 of dk and dv in place, and writes
    row 0 of dk and dv: its share plus the sum of `cls_part` over its
    parts. Two `__global__` launches on `cls_row_geometry` (one pass over
    the keys, then the merge in a fixed order) over f32 scratch allocated
    here."""
    name = "cls_row_attention_bwd"
    b, s, dh = _check_bwd(qkv, g, dqkv, num_heads, 1)
    _check(qkv, out, num_heads, 1)
    _check_scratch("lse", lse, (b, num_heads), qkv.device)
    if cls_part.dim() != 5:
        raise ValueError("cls_part must be [B, H, parts, 2, Dh]")
    cls_parts = cls_part.shape[2]
    _check_scratch("cls_part", cls_part, (b, num_heads, cls_parts, 2, dh),
                   qkv.device)
    geo = cls_row_geometry(qkv.dtype, dh, s)
    scratch = torch.empty((b, num_heads, geo.parts, 3, dh),
                          dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().cls_row_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dqkv.data_ptr(), cls_part.data_ptr(), cls_parts,
            scratch.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s, num_heads, dh,
            geo.run, geo.parts, float(scale), stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# ---------------- LayerNorm ----------------

LN_MAX_DIM = 8192  # the widest row `csrc/layernorm.cu` holds in registers


def _check_ln_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype \
            or t.shape != like.shape:
        raise ValueError(f"{name} must match x ({tuple(like.shape)}, "
                         f"{like.dtype}, {like.device}), got "
                         f"{tuple(t.shape)}, {t.dtype}, {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"kernel needs a contiguous, 16-byte aligned {name}")


def _check_ln(x: torch.Tensor, **params: torch.Tensor) -> tuple:
    """x [R, D] and the float32 [D] tensors `params`; returns (R, D)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs x on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"kernel takes x [R, D], got {tuple(x.shape)}")
    rows, d = x.shape
    if rows < 1 or d < 8 or d % 8 or d > LN_MAX_DIM:
        raise ValueError(f"LayerNorm kernel takes R >= 1 rows of D a multiple "
                         f"of 8 up to {LN_MAX_DIM}, got x {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("kernel needs a contiguous, 16-byte aligned x")
    for name, t in params.items():
        _check_scratch(name, t, (d,), x.device)
        if t.data_ptr() % 16:
            raise ValueError(f"kernel needs a 16-byte aligned {name}")
    return rows, d


def layernorm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  y: torch.Tensor, *, eps: float) -> None:
    """K7: y = LayerNorm(x) over the last axis, written into `y`.

    x and y [R, D] float32 or bfloat16, scale and bias float32 [D]."""
    name = "layernorm_fwd"
    rows, d = _check_ln(x, scale=scale, bias=bias)
    _check_ln_rows("y", y, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = load().layernorm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# K8's most blocks (and so partials): 4 for each of the H100's 132 SMs,
# enough loads in flight to cover the memory's latency. Decided here alone.
LN_BWD_MAX_PARTS = 4 * 132
# Must match kHeld and kBlock of `csrc/layernorm.cu`, whose entry point
# checks the strips against them: elements of a row one thread holds, at
# most, and threads a block while a row takes at most that many.
_LN_HELD, _LN_BLOCK = 32, 128


def layernorm_bwd_geometry(dtype: torch.dtype, rows: int,
                           d: int) -> SimpleNamespace:
    """K8's launch geometry for x [rows, d] of `dtype`:
      * `group`: threads a row (32, 64, 128 or 256: the fewest that hold it
        with 32 elements a thread); a block is 128 threads, or one group
        where that is wider, and takes `at_once` rows at once;
      * `strip`: rows a block, consecutive, a multiple of `at_once`: one
        group of rows while that needs at most LN_BWD_MAX_PARTS blocks, else
        as few more as keep to them;
      * `parts`: the blocks, each with a row; also the parts axis of the f32
        partials [parts, 2, d] that the second launch adds in order.
    Pure, and the one place this split is decided: the CPU tests check it,
    and the C entry point launches with it as given, refusing one that does
    not hold (CUDA error 1, invalid argument)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if rows < 1 or d < 8 or d % 8 or d > LN_MAX_DIM:
        raise ValueError(f"LayerNorm kernel takes R >= 1 rows of D a multiple "
                         f"of 8 up to {LN_MAX_DIM}, got {rows} x {d}")
    group = 32
    while group * _LN_HELD < d:
        group *= 2
    at_once = max(group, _LN_BLOCK) // group
    turns = -(-rows // at_once)
    per = -(-turns // min(turns, LN_BWD_MAX_PARTS))
    return SimpleNamespace(group=group, at_once=at_once, strip=per * at_once,
                           parts=-(-turns // per))


def layernorm_bwd_scratch(x: torch.Tensor) -> torch.Tensor:
    """The f32 scratch of one LayerNorm backward on x [R, D]: the blocks'
    column sums [parts, 2, D] of `layernorm_bwd_geometry`. Uninitialised:
    the kernel fills it. A meta x gives the shape without a card."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"kernel scratch needs a CUDA x, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"kernel takes x [R, D], got {tuple(x.shape)}")
    rows, d = x.shape
    parts = layernorm_bwd_geometry(x.dtype, rows, d).parts
    return torch.empty((parts, 2, d), dtype=torch.float32, device=x.device)


def layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                  dx: torch.Tensor, dscale: torch.Tensor, dbias: torch.Tensor,
                  partials: torch.Tensor, *, eps: float) -> None:
    """K8: backward of K7 from x, scale and the cotangent g of y. Writes dx
    (x's shape and dtype) and the float32 [D] dscale and dbias; `partials`
    is the scratch of `layernorm_bwd_scratch`. Two `__global__` launches on
    `layernorm_bwd_geometry`: the pass over the rows, then the sum of the
    blocks' partials."""
    name = "layernorm_bwd"
    rows, d = _check_ln(x, scale=scale, dscale=dscale, dbias=dbias)
    _check_ln_rows("g", g, x)
    _check_ln_rows("dx", dx, x)
    geo = layernorm_bwd_geometry(x.dtype, rows, d)
    _check_scratch("partials", partials, (geo.parts, 2, d), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = load().layernorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(), rows, d,
            float(eps), _DTYPE_CODES[x.dtype], geo.strip, geo.parts, stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1
    layernorm_bwd_rows[rows] = layernorm_bwd_rows.get(rows, 0) + 1


# ---------------- fused attention ----------------


def attention_strides(t: torch.Tensor):
    """The (batch, head, row) strides, in elements, of a [B, H, S, Dh] tensor
    the attention kernel can read or write by stride (Dh contiguous; where Dh
    is a multiple of 8, every row 16-byte aligned, as its vector loads need),
    else None."""
    sb, sh, ss, sd = t.stride()
    b, h, s, dh = t.shape
    if sd != 1 and dh > 1:
        return None
    per16 = 16 // t.element_size()
    if dh % 8 == 0 and (t.data_ptr() % 16 or (s > 1 and ss % per16)
                        or (h > 1 and sh % per16) or (b > 1 and sb % per16)):
        return None
    return sb, sh, ss


def _check_strided(name: str, t: torch.Tensor, like: torch.Tensor,
                   shape: tuple) -> tuple:
    """`t` on `like`'s device, of its dtype and of `shape`; returns its
    `attention_strides`."""
    if t.device != like.device or t.dtype != like.dtype \
            or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape} {like.dtype} on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} "
                         f"{t.device}")
    strides = attention_strides(t)
    if strides is None:
        raise ValueError(f"kernel needs {name} with a contiguous head dim "
                         f"(and 16-byte aligned rows where it is a multiple "
                         f"of 8), got strides {t.stride()}")
    return strides


# K9's forms (`csrc/fused_attention.cu`) by the code its entry point takes:
# bf16 at a head dim of 32, 64 or 128, and 3xTF32 (float32, and bf16 at any
# other head dim), each for many queries and for few.
_FLASH_FORMS = {"many_queries": 1, "few_queries": 2, "many_queries_tf32": 3,
                "few_queries_tf32": 4}
FLASH_FEW_ROWS = 32  # the most query rows of the few-query forms
FLASH_CHUNK = 128  # keys a staged chunk; a run is a multiple of it
FLASH_TF32_CHUNK = 32  # the same in the 3xTF32 forms (f32 rows)
FLASH_TF32_FWD_CHUNK = 16  # keys a staged chunk of "many_queries_tf32"
# The few-query forms split the keys of a (batch, head) into runs over
# blocks only where B * H is under their block target. In bf16 that is
# FLASH_BLOCKS (one block an SM of the 132): on an H100 one run was fastest
# at every path shape at or above it, where the merge launch costs 3-5 us,
# and three runs beat one below it (EgoMCQ one question at a time, B=5: 24
# against 33 us). In 3xTF32 it is FLASH_TF32_BLOCKS: on an H100 four runs
# were fastest at the EgoTaskQA t2i (B=8, Sk=785: B * H = 96), two at B=16,
# one at B=64 (PERF.md). A run holds at least FLASH_MIN_RUN keys where Sk
# has them, so that the f32 partials stay a few percent of the K/V bytes.
FLASH_BLOCKS = 132
FLASH_TF32_BLOCKS = 384
FLASH_MIN_RUN = 256
FLASH_STAGES = 2  # chunks in a block's ring, kStages of the source


def flash_tf32_dh(dh: int) -> int:
    """The head dim the 3xTF32 forms pad to with zeros: 16, 32, 64 or 128."""
    return next(p for p in (16, 32, 64, 128) if dh <= p)


def flash_fwd_geometry(dtype: torch.dtype, dh: int, sq: int, sk: int, b: int,
                       h: int) -> SimpleNamespace:
    """K9's launch geometry for q [B, H, Sq, Dh] over Sk keys in `dtype`:
      * `form`: "few_queries" at Sq <= FLASH_FEW_ROWS (t2i and text
        self-attention: a block every query row of a (batch, head) and a
        run of its keys) and "many_queries" at larger Sq (i2t: 64 query
        rows a block), for bf16 at a head dim of 32, 64 or 128; the same
        two structures in 3xTF32, "few_queries_tf32" and
        "many_queries_tf32", for float32 and for bf16 at any other head
        dim;
      * `run`: keys a block of a few-query form: Sk over ceil(target /
        (B * H)) rounded up to a multiple of the chunk, so all of Sk where
        B * H reaches the target (FLASH_BLOCKS and FLASH_CHUNK in bf16,
        FLASH_TF32_BLOCKS and FLASH_TF32_CHUNK in 3xTF32); at least
        FLASH_MIN_RUN (less only where Sk is);
      * `splits`: ceil(Sk / run), the blocks a (batch, head): the splits
        axis of the f32 partials [B, H, splits, Sq, Dh + 2] that a second
        launch merges in order where there is more than one;
      * `row_tiles`: 16-row tiles of the queries, 1 for Sq <= 16, else 2;
      * `stages`: the block's ring of staged chunks, FLASH_STAGES: one
        chunk in flight while one is multiplied;
      * `shared_bytes`: a block's dynamic shared memory. "few_queries": each
        stage holds the K and V rows of a chunk at a pitch of Dh + 8 bf16
        and their f32 bias, FLASH_CHUNK rows, or Sk rounded up to 16 where
        it is shorter; after the last chunk the warps' f32 partials, 256 *
        (dh + 2) bytes, where they need more. In 3xTF32 every tile is f32
        at the head dim of `flash_tf32_dh`, Q and K rows at a pitch of it
        + 8 floats, V rows + 4: "few_queries_tf32" a ring of the K, V and
        bias of FLASH_TF32_CHUNK keys (Sk rounded up to 8 * row_tiles, the
        keys a warp scores a chunk, where shorter) and the Q rows, or the
        4 warps' partials after the last chunk where they need more;
        "many_queries_tf32" the 64-row Q tile and one chunk's K, V and
        bias, FLASH_TF32_FWD_CHUNK keys.
    The many-query forms have `splits` 1 and no run, row tiles or stages;
    "many_queries" no dynamic shared memory (None). Pure, and the one place
    this geometry is decided: the CPU tests check it, and the C entry point
    launches with it as given, refusing any other (CUDA error 1, invalid
    argument)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if not 1 <= dh <= 128 or min(sq, sk, b, h) < 1:
        raise ValueError(f"attention kernel takes a head dim up to 128 and "
                         f"Sq, Sk, B, H >= 1, got Dh={dh}, Sq={sq}, Sk={sk}, "
                         f"B={b}, H={h}")
    many = dict(run=None, splits=1, row_tiles=None, stages=None)
    bf16 = dtype == torch.bfloat16 and dh in (32, 64, 128)
    if bf16 and sq > FLASH_FEW_ROWS:
        return SimpleNamespace(form="many_queries", shared_bytes=None, **many)
    dp = flash_tf32_dh(dh)
    row_bytes = 4 * (2 * dp + 12 + 1)  # a key's K, V and bias in 3xTF32
    if sq > FLASH_FEW_ROWS:
        return SimpleNamespace(form="many_queries_tf32",
                               shared_bytes=4 * 64 * (dp + 8)
                               + FLASH_TF32_FWD_CHUNK * row_bytes, **many)
    row_tiles, stages = (1 if sq <= 16 else 2), FLASH_STAGES
    if bf16:
        chunk, form, blocks = FLASH_CHUNK, "few_queries", FLASH_BLOCKS
        rows = min(chunk, -(-sk // 16) * 16)  # keys staged a chunk
        shared = max(stages * rows * (4 * dh + 36), 256 * (dh + 2))
    else:
        chunk, form = FLASH_TF32_CHUNK, "few_queries_tf32"
        blocks = FLASH_TF32_BLOCKS
        kw = chunk * row_tiles // 4  # keys a warp scores a chunk
        rows = min(chunk, -(-sk // kw) * kw)
        shared = max(stages * rows * row_bytes + 4 * 16 * row_tiles * (dp + 8),
                     4 * (4 * 16 * dp + 2 * 4 * 16))
    whole = -(-sk // chunk) * chunk  # Sk rounded up to whole chunks
    want = -(-blocks // (b * h))  # splits a (batch, head)
    run = min(max(-(-sk // (want * chunk)) * chunk, FLASH_MIN_RUN), whole)
    return SimpleNamespace(form=form, run=run, splits=-(-sk // run),
                           row_tiles=row_tiles, stages=stages,
                           shared_bytes=shared)


def flash_fwd_scratch(q: torch.Tensor, geometry: SimpleNamespace):
    """The f32 partials of one few-query K9 call on q [B, H, Sq, Dh] with
    more than one split, [B, H, splits, Sq, Dh + 2] (each row's unnormalised
    output, running max and sum in the log2 domain, of each split), else
    None. Uninitialised: the first launch fills it, the merge reads it."""
    if geometry.splits == 1:
        return None
    b, h, sq, dh = q.shape
    return torch.empty((b, h, geometry.splits, sq, dh + 2),
                       dtype=torch.float32, device=q.device)


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias, out: torch.Tensor, *, scale: float) -> None:
    """K9: out = softmax((q * scale) @ k^T + bias) @ v, written into `out`.

    q and out [B, H, Sq, Dh], k and v [B, H, Sk, Dh], float32 or bfloat16,
    any head dim up to 128, each read or written by its own strides (Dh
    contiguous; rows 16-byte aligned where Dh is a multiple of 8); `bias`
    is None or a float32 additive row [B or 1, H or 1, 1, Sk], Sk
    contiguous, broadcast over the axes of size 1. Runs the form that
    `flash_fwd_geometry` names: one `__global__` launch, two for a
    few-query form at more than one split (the split kernel, then the merge
    of its f32 partials, allocated here). Counts the launch in
    `launch_counts` and, by form, in `flash_form_counts`."""
    name = "fused_attention_fwd"
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs q on a CUDA device, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"kernel takes q [B, H, Sq, Dh] and k, v [B, H, Sk, "
                         f"Dh], got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    if not 1 <= dh <= 128 or sq < 1 or sk < 1:
        raise ValueError(f"attention kernel takes a head dim up to 128 and "
                         f"Sq, Sk >= 1, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    strides = (*_check_strided("q", q, q, (b, h, sq, dh)),
               *_check_strided("k", k, q, (b, h, sk, dh)),
               *_check_strided("v", v, q, (b, h, sk, dh)),
               *_check_strided("out", out, q, (b, h, sq, dh)))
    bias_ptr, bias_b, bias_h = None, 0, 0
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32 \
                or bias.dim() != 4 or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h) \
                or tuple(bias.shape[2:]) != (1, sk) \
                or (sk > 1 and bias.stride(3) != 1):
            raise ValueError(f"bias must be float32 [{b} or 1, {h} or 1, 1, "
                             f"{sk}] on {q.device} with contiguous keys, got "
                             f"{tuple(bias.shape)} {bias.dtype} {bias.device} "
                             f"strides {bias.stride()}")
        bias_ptr = bias.data_ptr()
        bias_b = bias.stride(0) if bias.shape[0] > 1 else 0
        bias_h = bias.stride(1) if bias.shape[1] > 1 else 0
    geo = flash_fwd_geometry(q.dtype, dh, sq, sk, b, h)
    partials = flash_fwd_scratch(q, geo)

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = load().fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), None if partials is None else partials.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, sk, dh, *strides, bias_b, bias_h,
            float(scale), _FLASH_FORMS[geo.form], geo.run or 0, geo.splits,
            geo.row_tiles or 0, geo.stages or 0, geo.shared_bytes or 0,
            stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1
    flash_form_counts[geo.form] += 1


# ---------------- general divided attention ----------------

GENERAL_MAX_DH = 256  # the widest head dim `csrc/divided_attention_general.cu` takes
_AXIS_CODES = {"space": 0, "time": 1}


def _strides_arg(t: torch.Tensor, component: bool):
    """The element strides of a [B, S, 3, H, Dh] (`component`) or
    [B, S, H, Dh] view as the kernels take them: (component, batch, row,
    head, element), an int64[5] array."""
    if component:
        sb, sr, sc, sh, sd = t.stride()
    else:
        (sb, sr, sh, sd), sc = t.stride(), 0
    return (ctypes.c_int64 * 5)(sc, sb, sr, sh, sd)


def _check_general(qkv: torch.Tensor, axis: str, num_frames: int,
                   **others: torch.Tensor) -> tuple:
    """qkv [B, S, 3, H, Dh] on a CUDA device, float32 or bfloat16, with
    S = 1 + num_frames * N; each of `others` [B, S, H, Dh] (or qkv's shape
    for `dqkv`) of qkv's dtype on its device. Returns (B, S, H, Dh)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"kernel needs qkv on a CUDA device, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"kernel takes qkv [B, S, 3, H, Dh], got "
                         f"{tuple(qkv.shape)}")
    if axis not in _AXIS_CODES:
        raise ValueError(f"axis must be one of {tuple(_AXIS_CODES)}, got {axis!r}")
    b, s, _, h, dh = qkv.shape
    if not 1 <= dh <= GENERAL_MAX_DH:
        raise ValueError(f"head dim {dh} must be in 1..{GENERAL_MAX_DH}")
    if num_frames < 1 or s < 2 or (s - 1) % num_frames:
        raise ValueError(f"S={s} is not 1 + {num_frames} frames * N patches")
    if max(b, h) > 65535 or s >= 2 ** 31:
        raise ValueError(f"B={b}, H={h} or S={s} is past the kernel's grid")
    for name, t in others.items():
        shape = tuple(qkv.shape) if name == "dqkv" else (b, s, h, dh)
        if t.device != qkv.device or t.dtype != qkv.dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {qkv.dtype} on "
                             f"{qkv.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    return b, s, h, dh


# The tiling of K10 and K11 (`csrc/divided_attention_general.cu`): 64
# resident rows a block, 64 rows a streamed tile (32 in K11 at the head dims
# where 64 do not fit), as 16 x 16 threads of 4 x 4; score tiles padded by
# 16 columns.
GENERAL_BLOCK_Q = GENERAL_BLOCK_K = 64
SHARED_BYTES_MAX = 232448  # a block's dynamic shared memory on Hopper
# The most a block may hold and still share its SM with a second one: the
# SM's 233,472 bytes less 1 KB reserved a block, halved.
SHARED_BYTES_TWO = 115712


def general_fwd_geometry(dtype: torch.dtype, dh: int, s: int,
                         num_frames: int, axis: str) -> SimpleNamespace:
    """K10's launch geometry for qkv of `dtype` at head dim `dh` and
    S = 1 + num_frames * N, on `axis`:
      * `cols`: patch columns a group (N on the space axis, where a group
        is a frame; on the time axis a group is `cols` columns over all
        frames, F * cols <= 63 rows, so the rows and the CLS row share one
        64-row tile, spread evenly over the groups);
      * `parts`: groups, which is also the parts axis of the CLS row's f32
        partials [B, H, parts, Dh + 2];
      * `query_tiles`: 64-row tiles a group, the CLS row being unit 0;
      * `ld`: the Q/K/V row stride in floats, the head dim padded to a
        multiple of 4, then to an odd number of 16-byte words (no bank
        conflicts between the 8 rows of a float4 read);
      * `stages`: the K/V ring, 2 where a group has more than one key tile
        and it fits in SHARED_BYTES_MAX, else 1;
      * `shared_bytes`: Q, the K and V ring and P, all f32.
    Pure, and the one place this geometry is decided: the CPU tests check
    it, and the C entry point launches with it as given, refusing only tile
    rows other than the 64 it was compiled for."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    if axis not in _AXIS_CODES:
        raise ValueError(f"axis must be one of {tuple(_AXIS_CODES)}, got {axis!r}")
    if not 1 <= dh <= GENERAL_MAX_DH:
        raise ValueError(f"head dim {dh} must be in 1..{GENERAL_MAX_DH}")
    if num_frames < 1 or s < 2 or (s - 1) % num_frames:
        raise ValueError(f"S={s} is not 1 + {num_frames} frames * N patches")
    bq, bk = GENERAL_BLOCK_Q, GENERAL_BLOCK_K
    n = (s - 1) // num_frames
    dp = -(-dh // 4) * 4
    ld = dp if (dp // 4) % 2 else dp + 4

    def shared(stages):
        return 4 * (bq * ld + 2 * stages * bk * ld + bq * (bk + 16))

    if axis == "space":
        cols, parts, rows = n, num_frames, n
    else:
        widest = min(n, max(1, (bq - 1) // num_frames))
        cols = -(-n // -(-n // widest))  # the same width in every group
        parts = -(-n // cols)
        rows = num_frames * cols
    key_tiles = -(-(rows + 1) // bk)
    stages = 2 if key_tiles > 1 and shared(2) <= SHARED_BYTES_MAX else 1
    return SimpleNamespace(block_q=bq, block_k=bk, stages=stages,
                           shared_bytes=shared(stages), parts=parts,
                           query_tiles=-(-(rows + 1) // bq), cols=cols,
                           ld=ld)


def general_bwd_geometry(dtype: torch.dtype, dh: int, s: int,
                         num_frames: int, axis: str) -> SimpleNamespace:
    """K11's launch geometry, on K10's groups (`cols`, `parts`, `ld` and
    the 64-unit tiles of `general_fwd_geometry`):
      * `tiles`: 64-unit resident tiles a group, of queries in the query
        pass and of keys in the key pass (the grid is tiles x parts, H, B);
      * `query_pass`, `key_pass`: each pass's `rows` (the rows of a
        streamed tile: 64, or 32 where 64 do not fit in SHARED_BYTES_MAX),
        `stages` (the ring: 2 where the group has more than one streamed
        tile and the second stage does not cost the SM its second block,
        else 1) and `shared_bytes`: two resident tiles (Q and G, or K and
        V), two streamed tiles a stage (K and V, or Q and G) and one score
        tile (dS) in the query pass; in the key pass two score tiles (P^T
        and dS^T) and the streamed rows' lse and delta a stage; all f32;
      * the f32 scratch: `delta` [B, H, S] and `cls` [B, H, parts, 3, Dh]
        (row 0's partials of dq and shares of dk and dv, one a group).
    Pure, and the one place this geometry is decided: the C entry point
    launches with it as given."""
    fwd = general_fwd_geometry(dtype, dh, s, num_frames, axis)
    bq, ld = fwd.block_q, fwd.ld
    n = (s - 1) // num_frames
    units = 1 + (n if axis == "space" else num_frames * fwd.cols)

    def shared(rows, stages, scores):
        # scores: 1 in the query pass, 2 in the key pass, which also
        # stages 2 floats (lse, delta) a streamed row
        return 4 * (2 * bq * ld + 2 * stages * rows * ld
                    + scores * bq * (rows + 16)
                    + (scores - 1) * 2 * stages * rows)

    def pass_geometry(scores):
        # 32 rows fit at every head dim up to GENERAL_MAX_DH
        rows = next(r for r in (GENERAL_BLOCK_K, GENERAL_BLOCK_K // 2)
                    if shared(r, 1, scores) <= SHARED_BYTES_MAX)
        one = shared(rows, 1, scores)
        room = SHARED_BYTES_TWO if one <= SHARED_BYTES_TWO \
            else SHARED_BYTES_MAX
        stages = 2 if -(-units // rows) > 1 \
            and shared(rows, 2, scores) <= room else 1
        return SimpleNamespace(rows=rows, stages=stages,
                               shared_bytes=shared(rows, stages, scores))

    return SimpleNamespace(block_q=bq, cols=fwd.cols, parts=fwd.parts,
                           tiles=fwd.query_tiles, ld=ld,
                           query_pass=pass_geometry(1),
                           key_pass=pass_geometry(2))


def general_fwd_scratch(qkv: torch.Tensor, geometry: SimpleNamespace
                        ) -> torch.Tensor:
    """The f32 scratch of one K10 call on qkv [B, S, 3, H, Dh]: the CLS
    row's partial (m, l, acc[Dh]) of each group, [B, H, parts, Dh + 2].
    Uninitialised: the first launch fills it, the second reads it."""
    b, _, _, h, dh = qkv.shape
    return torch.empty((b, h, geometry.parts, dh + 2), dtype=torch.float32,
                       device=qkv.device)


def general_bwd_scratch(qkv: torch.Tensor, geometry: SimpleNamespace
                        ) -> tuple:
    """The f32 scratch of one K11 call on qkv [B, S, 3, H, Dh]: `delta`
    [B, H, S] (each row's g.o, from the query pass to the key pass) and
    `cls` [B, H, parts, 3, Dh] (each group's partial of row 0's dq and
    share of its dk and dv, before scale, for the merge). Uninitialised:
    the passes fill them."""
    b, s, _, h, dh = qkv.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=qkv.device)
    cls = torch.empty((b, h, geometry.parts, 3, dh), dtype=torch.float32,
                      device=qkv.device)
    return delta, cls


def divided_attention_general_fwd(qkv: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, *, scale: float,
                                  axis: str, num_frames: int) -> None:
    """K10: divided attention with the CLS splice over all S rows, written
    into `out`, and each row's log-sum-exp of its live logits scale * q.k
    (natural log) into `lse`, f32 [B, H, S] contiguous. qkv [B, S, 3, H,
    Dh] and out [B, S, H, Dh], float32 or bfloat16, any head dim up to
    GENERAL_MAX_DH, each read or written by its own strides (any view). Two
    `__global__` launches: the tiles of each group (writing the CLS row's
    partials), then the merge of row 0."""
    name = "divided_attention_general_fwd"
    b, s, h, dh = _check_general(qkv, axis, num_frames, out=out)
    _check_scratch("lse", lse, (b, h, s), qkv.device)
    geo = general_fwd_geometry(qkv.dtype, dh, s, num_frames, axis)
    partials = general_fwd_scratch(qkv, geo)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().general_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
            partials.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s, h, dh,
            num_frames, _AXIS_CODES[axis], float(scale),
            _strides_arg(qkv, True), _strides_arg(out, False), geo.block_q,
            geo.block_k, geo.cols, geo.stages, geo.query_tiles, geo.parts,
            geo.ld, geo.shared_bytes, stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


def divided_attention_general_bwd(qkv: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, g: torch.Tensor,
                                  dqkv: torch.Tensor, *, scale: float,
                                  axis: str, num_frames: int) -> None:
    """K11: backward of K10. From qkv, K10's `out` and `lse` and the
    cotangent g [B, S, H, Dh] of out, writes dq, dk and dv into dqkv [B, S,
    3, H, Dh]; each tensor by its own strides. Three `__global__` launches
    (a query pass, a key pass and the merge of row 0) over the f32 scratch
    of `general_bwd_scratch`, allocated here."""
    name = "divided_attention_general_bwd"
    b, s, h, dh = _check_general(qkv, axis, num_frames, out=out, g=g,
                                 dqkv=dqkv)
    _check_scratch("lse", lse, (b, h, s), qkv.device)
    geo = general_bwd_geometry(qkv.dtype, dh, s, num_frames, axis)
    delta, cls = general_bwd_scratch(qkv, geo)
    qp, kp = geo.query_pass, geo.key_pass
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().general_attention_bwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), delta.data_ptr(), cls.data_ptr(),
            _DTYPE_CODES[qkv.dtype], b, s, h, dh, num_frames,
            _AXIS_CODES[axis], float(scale), _strides_arg(qkv, True),
            _strides_arg(out, False), _strides_arg(g, False),
            _strides_arg(dqkv, True), geo.block_q, geo.cols, geo.tiles,
            geo.parts, geo.ld, qp.rows, qp.stages, qp.shared_bytes, kp.rows,
            kp.stages, kp.shared_bytes, stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1
