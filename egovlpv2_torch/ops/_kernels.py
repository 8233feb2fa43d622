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
    "layernorm.cu": ("layernorm_fwd", "layernorm_bwd", "layernorm_bwd_parts"),
    "fused_attention.cu": ("fused_attention_fwd",),
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
                 "fused_attention_fwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
    for fn in (fns.space_attention_fwd, fns.time_attention_fwd):
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr]
        fn.restype = i32
    fns.cls_row_attention_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                          f32, ptr]
    fns.cls_row_attention_fwd.restype = i32
    for fn in (fns.space_attention_bwd, fns.time_attention_bwd):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                       f32, ptr]
        fn.restype = i32
    fns.cls_row_attention_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                          i32, i32, i32, f32, ptr]
    fns.cls_row_attention_bwd.restype = i32
    fns.attention_bwd_parts.argtypes = [i32, i32, i32, i32, i32]
    fns.attention_bwd_parts.restype = i32
    fns.layernorm_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]
    fns.layernorm_fwd.restype = i32
    fns.layernorm_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                  f32, i32, ptr]
    fns.layernorm_bwd.restype = i32
    fns.layernorm_bwd_parts.argtypes = [i32, i32]
    fns.layernorm_bwd_parts.restype = i32
    fns.fused_attention_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 14 \
        + [f32, ptr]
    fns.fused_attention_fwd.restype = i32
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


def _launch_grouped(name: str, qkv, out, *, num_heads, num_frames, scale):
    b, s, dh = _check(qkv, out, num_heads, num_frames)
    fn = getattr(load(), name)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype],
                  b, s, num_heads, dh, num_frames, float(scale), stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


def space_attention_fwd(qkv: torch.Tensor, out: torch.Tensor, *,
                        num_heads: int, num_frames: int, scale: float) -> None:
    """K1: rows 1..S-1 of divided SPACE attention, written into `out`.

    qkv [B, S, 3*H*Dh] (the qkv Linear output), out [B, S, H*Dh]."""
    _launch_grouped("space_attention_fwd", qkv, out, num_heads=num_heads,
                    num_frames=num_frames, scale=scale)


def time_attention_fwd(qkv: torch.Tensor, out: torch.Tensor, *,
                       num_heads: int, num_frames: int, scale: float) -> None:
    """K2: rows 1..S-1 of divided TIME attention, written into `out`."""
    _launch_grouped("time_attention_fwd", qkv, out, num_heads=num_heads,
                    num_frames=num_frames, scale=scale)


def cls_row_attention_fwd(qkv: torch.Tensor, out: torch.Tensor, *,
                          num_heads: int, scale: float) -> None:
    """K3: row 0 (the CLS query over all S keys), written into `out`."""
    name = "cls_row_attention_fwd"
    b, s, dh = _check(qkv, out, num_heads, 1)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().cls_row_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s,
            num_heads, dh, float(scale), stream)
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


def _bwd_parts(name: str, dtype: torch.dtype, s: int, dh: int,
               num_frames: int) -> int:
    return load().attention_bwd_parts(int(name == "time_attention_bwd"),
                                      _DTYPE_CODES[dtype], s, dh, num_frames)


def attention_bwd_scratch(qkv: torch.Tensor, *, num_heads: int,
                          num_frames: int, axis: str) -> tuple:
    """The f32 scratch of one backward on `axis` ("space" or "time"):
    `stats` [2, B, H, S] (each patch row's log-sum-exp and delta) and
    `cls_part` [B, H, parts, 2, Dh] (the blocks' shares of the CLS key's dk
    and dv). Uninitialised: the grouped backward fills both."""
    if qkv.device.type != "cuda":
        raise ValueError(f"kernel scratch needs a CUDA qkv, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv.dtype}")
    b, s, w3 = qkv.shape
    dh = w3 // (3 * num_heads)
    parts = _bwd_parts(f"{axis}_attention_bwd", qkv.dtype, s, dh, num_frames)
    stats = torch.empty((2, b, num_heads, s), dtype=torch.float32,
                        device=qkv.device)
    cls_part = torch.empty((b, num_heads, parts, 2, dh), dtype=torch.float32,
                           device=qkv.device)
    return stats, cls_part


def _launch_grouped_bwd(name: str, qkv, g, dqkv, stats, cls_part, *,
                        num_heads, num_frames, scale):
    b, s, dh = _check_bwd(qkv, g, dqkv, num_heads, num_frames)
    fns = load()
    parts = _bwd_parts(name, qkv.dtype, s, dh, num_frames)
    _check_scratch("stats", stats, (2, b, num_heads, s), qkv.device)
    _check_scratch("cls_part", cls_part, (b, num_heads, parts, 2, dh),
                   qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = getattr(fns, name)(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            cls_part.data_ptr(), _DTYPE_CODES[qkv.dtype], b, s, num_heads, dh,
            num_frames, float(scale), stream)
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
    _launch_grouped_bwd("space_attention_bwd", qkv, g, dqkv, stats, cls_part,
                        num_heads=num_heads, num_frames=num_frames,
                        scale=scale)


def time_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                       dqkv: torch.Tensor, stats: torch.Tensor,
                       cls_part: torch.Tensor, *, num_heads: int,
                       num_frames: int, scale: float) -> None:
    """K5: backward of K2; arguments as `space_attention_bwd`."""
    _launch_grouped_bwd("time_attention_bwd", qkv, g, dqkv, stats, cls_part,
                        num_heads=num_heads, num_frames=num_frames,
                        scale=scale)


def cls_row_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                          dqkv: torch.Tensor, cls_part: torch.Tensor, *,
                          num_heads: int, scale: float) -> None:
    """K6: backward of K3, after K4 or K5 on the same stream. Writes row 0
    of dq, adds the CLS query's share to rows 1..S-1 of dk and dv in place,
    and writes row 0 of dk and dv: that share plus the sum of `cls_part`
    over its parts."""
    name = "cls_row_attention_bwd"
    b, s, dh = _check_bwd(qkv, g, dqkv, num_heads, 1)
    if cls_part.dim() != 5:
        raise ValueError("cls_part must be [B, H, parts, 2, Dh]")
    parts = cls_part.shape[2]
    _check_scratch("cls_part", cls_part, (b, num_heads, parts, 2, dh),
                   qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = load().cls_row_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            cls_part.data_ptr(), parts, _DTYPE_CODES[qkv.dtype], b, s,
            num_heads, dh, float(scale), stream)
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


def layernorm_bwd_scratch(x: torch.Tensor) -> torch.Tensor:
    """The f32 scratch of one LayerNorm backward on x [R, D]: the blocks'
    column sums [parts, 2, D], sized from the grid the kernel launches.
    Uninitialised: the kernel fills it."""
    rows, d = _check_ln(x)
    parts = load().layernorm_bwd_parts(rows, d)
    return torch.empty((parts, 2, d), dtype=torch.float32, device=x.device)


def layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                  dx: torch.Tensor, dscale: torch.Tensor, dbias: torch.Tensor,
                  partials: torch.Tensor, *, eps: float) -> None:
    """K8: backward of K7 from x, scale and the cotangent g of y. Writes dx
    (x's shape and dtype) and the float32 [D] dscale and dbias; `partials`
    is the scratch of `layernorm_bwd_scratch`. Two `__global__` launches:
    the pass over the rows, then the sum of the blocks' partials."""
    name = "layernorm_bwd"
    rows, d = _check_ln(x, scale=scale, dscale=dscale, dbias=dbias)
    _check_ln_rows("g", g, x)
    _check_ln_rows("dx", dx, x)
    parts = load().layernorm_bwd_parts(rows, d)
    _check_scratch("partials", partials, (parts, 2, d), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = load().layernorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), partials.data_ptr(), rows, d,
            float(eps), _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1


# ---------------- fused attention ----------------


def attention_strides(t: torch.Tensor):
    """The (batch, head, row) strides, in elements, of a [B, H, S, Dh] tensor
    the attention kernel can read or write by stride (Dh contiguous, every
    row 16-byte aligned), else None."""
    sb, sh, ss, sd = t.stride()
    b, h, s, _ = t.shape
    per16 = 16 // t.element_size()
    if sd != 1 or t.data_ptr() % 16 or (s > 1 and ss % per16) \
            or (h > 1 and sh % per16) or (b > 1 and sb % per16):
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
        raise ValueError(f"kernel needs {name} with a contiguous head dim and "
                         f"16-byte aligned rows, got strides {t.stride()}")
    return strides


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias, out: torch.Tensor, *, scale: float) -> None:
    """K9: out = softmax((q * scale) @ k^T + bias) @ v, written into `out`.

    q and out [B, H, Sq, Dh], k and v [B, H, Sk, Dh], float32 or bfloat16,
    each read or written by its own strides (Dh contiguous, rows 16-byte
    aligned); `bias` is None or a float32 additive row [B or 1, H or 1, 1,
    Sk], Sk contiguous, broadcast over the axes of size 1."""
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
    if dh < 8 or dh % 8 or dh > 128 or sq < 1 or sk < 1:
        raise ValueError(f"attention kernel takes a head dim that is a "
                         f"multiple of 8 up to 128 and Sq, Sk >= 1, got q "
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

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = load().fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), _DTYPE_CODES[q.dtype], b, h, sq, sk, dh,
            *strides, bias_b, bias_h, float(scale), stream)
    _raise_on_error(name, code)
    launch_counts[name] += 1
