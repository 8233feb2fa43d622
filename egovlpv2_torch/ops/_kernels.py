"""Build and bind the hand-written CUDA kernels of `csrc/`.

The sources are compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface, named by a hash of the sources and flags, under
`build/egovlpv2_torch/` of the checkout, at first CUDA use; it is loaded
with `ctypes`. Each wrapper checks its tensors, launches on PyTorch's
current stream, raises if the launch returned a CUDA error, and adds one
to its entry of `launch_counts`.

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

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "divided_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egovlpv2_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last reset, counted where they launch.
launch_counts = {"space_attention_fwd": 0, "time_attention_fwd": 0,
                 "cls_row_attention_fwd": 0}


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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"divided_attention_{digest}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once a process."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("space_attention_fwd", "time_attention_fwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr]
        fn.restype = i32
    lib.cls_row_attention_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                          f32, ptr]
    lib.cls_row_attention_fwd.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


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
