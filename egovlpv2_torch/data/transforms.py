"""Video transforms (host-side numpy + cv2), channels-last: the port's copy
of `egovlpv2_tpu/data/transforms.py`. The normalisation takes the C++
kernel of `native/` (`data/native.py`) where it is built, else numpy's.

Capability-parity target: `EgoVLPv2/data_loader/transforms.py:42-70`:
  train: RandomResizedCrop(224, scale=(0.5, 1.0)) + HFlip(0.5) + Normalize
  eval:  Resize(short=256) -> CenterCrop(256) -> Resize(224x224) -> Normalize

Two normalization regimes (SURVEY.md §7 hard-part 6):
  * ImageNet 0-1 (all datasets except EPIC): mean/std on /255 floats
  * EPIC 0-255 (EpicKitchens_MIR_dataset.py:147-159): mean 123.675... on raw

All ops take/return float32 [T, H, W, C] (channels-last, the layout the
patchify conv consumes directly, vs the reference's [T, C, H, W]).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from egovlpv2_torch.core.config import NORM_STATS

IMAGENET_MEAN = np.array(NORM_STATS["imagenet"][0], np.float32)
IMAGENET_STD = np.array(NORM_STATS["imagenet"][1], np.float32)
EPIC_MEAN = np.array(NORM_STATS["epic"][0], np.float32)
EPIC_STD = np.array(NORM_STATS["epic"][1], np.float32)


def _resize_clip(clip: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize every frame (cv2 INTER_LINEAR == torch bilinear,
    antialias=False); cv2 is imported here, at the first call."""
    import cv2

    t, h, w, c = clip.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return clip
    out = np.empty((t, oh, ow, c), clip.dtype)
    for i in range(t):
        out[i] = cv2.resize(clip[i], (ow, oh), interpolation=cv2.INTER_LINEAR)
    return out


def resize_short_side(clip: np.ndarray, size: int) -> np.ndarray:
    t, h, w, c = clip.shape
    if h < w:
        oh, ow = size, max(int(round(w * size / h)), 1)
    else:
        oh, ow = max(int(round(h * size / w)), 1), size
    return _resize_clip(clip, (oh, ow))


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    t, h, w, c = clip.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return clip[:, top : top + size, left : left + size]


def random_resized_crop(
    clip: np.ndarray,
    size: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> np.ndarray:
    """torchvision RandomResizedCrop semantics, one crop shared by all frames."""
    t, h, w, c = clip.shape
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = clip[:, top : top + ch, left : left + cw]
            return _resize_clip(crop, (size, size))
    # fallback: center crop of the largest valid window
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    crop = center_crop_hw(clip, ch, cw)
    return _resize_clip(crop, (size, size))


def center_crop_hw(clip: np.ndarray, ch: int, cw: int) -> np.ndarray:
    t, h, w, c = clip.shape
    top = (h - ch) // 2
    left = (w - cw) // 2
    return clip[:, top : top + ch, left : left + cw]


def hflip(clip: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return clip[:, :, ::-1]
    return clip


def normalize(clip: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (clip - mean) / std


def _normalize_out(clip: np.ndarray, mean: np.ndarray,
                   std: np.ndarray) -> np.ndarray:
    """Contiguous-float32 normalize for the transform tails; the C++
    in-place kernel where it is built (the numpy broadcast allocates two
    temporaries). A view of caller data is copied first, so inputs are
    never mutated."""
    from egovlpv2_torch.data import native

    if native.available():
        if (clip.dtype != np.float32 or not clip.flags.c_contiguous
                or not clip.flags.owndata or clip.base is not None):
            clip = np.ascontiguousarray(clip, np.float32)
            if clip.base is not None:  # still a view (already contiguous)
                clip = clip.copy()
        return native.normalize_inplace(clip, mean, std)
    return np.ascontiguousarray(normalize(clip, mean, std), np.float32)


def train_transform(
    clip01: np.ndarray,
    rng: np.random.Generator,
    size: int = 224,
    scale: Tuple[float, float] = (0.5, 1.0),
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
    normalize: bool = True,
) -> np.ndarray:
    """clip01: float32 [T, H, W, C] in [0, 1] (or raw 0-255 for EPIC regime).

    `normalize=False` returns the geometric pipeline only (see
    eval_transform)."""
    clip = random_resized_crop(clip01, size, rng, scale=scale)
    clip = hflip(clip, rng)
    if not normalize:
        return clip
    return _normalize_out(clip, mean, std)


def train_transform_uint8(
    clip01: np.ndarray,
    rng: np.random.Generator,
    size: int = 224,
    scale: Tuple[float, float] = (0.5, 1.0),
) -> np.ndarray:
    """The geometric train pipeline only, quantized back to uint8 ([0, 1]
    regime): the model normalizes on the device (`uint8_norm` in
    VideoEncoderConfig), so the host ships 4x fewer bytes a batch."""
    clip = train_transform(clip01, rng, size=size, scale=scale,
                           normalize=False)
    return np.round(np.clip(clip, 0.0, 1.0) * 255.0).astype(np.uint8)


def eval_transform(
    clip01: np.ndarray,
    size: int = 224,
    intermediate: int = 256,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
    normalize: bool = True,
) -> np.ndarray:
    """`normalize=False` returns the geometric pipeline only (caller ships
    compact un-normalized frames and normalizes on device — quarters the
    host->device bytes when the input is uint8; see FeatureExtractor's
    `device_norm`)."""
    clip = resize_short_side(clip01, intermediate)
    clip = center_crop(clip, intermediate)
    clip = _resize_clip(clip, (size, size))
    if not normalize:
        return clip
    return _normalize_out(clip, mean, std)
