"""ctypes bindings for the C++ host preprocessing library of the repo's
`native/` (the port's copy of `egovlpv2_tpu/data/native.py`; the library
and its source are shared, not copied).

`load()` finds `native/libvideoproc.so`, or builds it once from
`native/videoproc.cpp` with `native/Makefile` where `make` and `g++` are
present, and gives None when neither works; callers then take the numpy /
cv2 path of `egovlpv2_torch.data.transforms`. Build by hand with
`make -C native`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "libvideoproc.so"),
        os.environ.get("EGOVLP_VIDEOPROC", ""),
    ):
        if cand and os.path.exists(cand):
            return cand
    _try_build(os.path.join(here, "native"))
    cand = os.path.join(here, "native", "libvideoproc.so")
    return cand if os.path.exists(cand) else None


def _try_build(native_dir: str) -> None:
    """Self-provision: build libvideoproc.so once if a compiler is present
    (set EGOVLP_NO_NATIVE_BUILD=1 to disable).

    Concurrency: multiple loader workers / jobs can hit a fresh checkout at
    once. An exclusive flock serializes the builds (the Makefile additionally
    compiles to a temp and atomic-renames, so a reader never dlopens a
    partial .so); whoever loses the race finds the finished library after
    acquiring the lock and skips the compile via make's mtime check."""
    import shutil
    import subprocess

    if os.environ.get("EGOVLP_NO_NATIVE_BUILD"):
        return
    if not os.path.exists(os.path.join(native_dir, "videoproc.cpp")):
        return
    if shutil.which("make") is None or shutil.which("g++") is None:
        return
    try:
        import fcntl

        print("egovlpv2_torch: building native/libvideoproc.so "
              "(one-time, may take a minute)...", flush=True)
        with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                subprocess.run(["make", "-C", native_dir], check=False,
                               capture_output=True, timeout=180)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except Exception:
        pass


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # unreadable/corrupt .so (e.g. from an interrupted build): fall back
        # to the numpy path rather than crashing the loader worker
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.clip_resize_bilinear_u8.argtypes = [u8p, c, c, c, c, f32p, c, c]
    lib.clip_resize_bilinear_f32.argtypes = [f32p, c, c, c, c, f32p, c, c]
    lib.clip_crop_resize_normalize_u8.argtypes = [
        u8p, c, c, c, c, c, c, c, c, c, c, ctypes.c_float, f32p, f32p, f32p,
    ]
    lib.clip_normalize_f32.argtypes = [f32p, ctypes.c_int64, c, f32p, f32p]
    lib.sample_frame_indices.argtypes = [c, c, c, c, i64p,
                                         ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def resize_bilinear(clip: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8/float32 [T, H, W, C] -> float32 [T, OH, OW, C]."""
    lib = load()
    assert lib is not None
    t, h, w, c = clip.shape
    out = np.empty((t, oh, ow, c), np.float32)
    if clip.dtype == np.uint8:
        lib.clip_resize_bilinear_u8(np.ascontiguousarray(clip), t, h, w, c,
                                    out, oh, ow)
    else:
        lib.clip_resize_bilinear_f32(
            np.ascontiguousarray(clip, np.float32), t, h, w, c, out, oh, ow
        )
    return out


def crop_resize_normalize(
    clip_u8: np.ndarray,
    top: int,
    left: int,
    crop_h: int,
    crop_w: int,
    size: int,
    hflip: bool,
    mean: np.ndarray,
    std: np.ndarray,
    scale: float = 1.0 / 255.0,
) -> np.ndarray:
    """Fused train-path transform on a uint8 clip."""
    lib = load()
    assert lib is not None
    t, h, w, c = clip_u8.shape
    out = np.empty((t, size, size, c), np.float32)
    lib.clip_crop_resize_normalize_u8(
        np.ascontiguousarray(clip_u8), t, h, w, c, top, left, crop_h, crop_w,
        size, int(hflip), np.float32(scale),
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), out,
    )
    return out


def normalize_inplace(clip: np.ndarray, mean: np.ndarray, std: np.ndarray):
    lib = load()
    assert lib is not None
    assert clip.dtype == np.float32 and clip.flags.c_contiguous
    c = clip.shape[-1]
    lib.clip_normalize_f32(clip, clip.size // c, c,
                           np.ascontiguousarray(mean, np.float32),
                           np.ascontiguousarray(std, np.float32))
    return clip
