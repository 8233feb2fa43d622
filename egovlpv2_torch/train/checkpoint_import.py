"""Importer of published EgoVLPv2 weights (port of
`egovlpv2_tpu/train/checkpoint_import.py`).

Maps the reference state_dict names (`EgoVLPv2/model/model.py` /
`model_epic_charades.py` module tree, with the DataParallel 'module.' prefix
fix of `utils/util.py:31-57` and the temporal-embedding inflation of
`model/model.py:532-574`) onto the port's `state_dict`. The name map is the
JAX package's, kept as this package's own copy: it builds the flax-shaped
tree (Dense `kernel` [in, out], the patch `kernel` [H, W, I, O], `scale`,
`embedding`), so the report lists the same flax paths and shapes, and each
tensor then goes to the port's name and layout through `weights.flax_path`
(a Dense weight back to [out, in]).

Works from a torch .pth (loaded on the CPU) or from any {name: np.ndarray}
dict, so tests exercise the mapping without the published file.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from egovlpv2_torch.weights import _flatten, flax_path


def strip_module_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """DataParallel 'module.' prefix fix (utils/util.py:31-57)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def inflate_temporal_embed(emb: np.ndarray, num_frames: int,
                           mode: str = "bilinear") -> np.ndarray:
    """Cross-frame-count portability (model.py:532-574): truncate when the
    checkpoint has more frames; zero-pad or linearly interpolate when fewer."""
    load_frames = emb.shape[1]
    if load_frames == num_frames:
        return emb
    if load_frames > num_frames:
        return emb[:, :num_frames]
    if mode == "zeros":
        out = np.zeros((emb.shape[0], num_frames, emb.shape[2]), emb.dtype)
        out[:, :load_frames] = emb
        return out
    # bilinear over the frame axis with align_corners=True semantics
    dst = np.linspace(0, load_frames - 1, num_frames)
    out = np.empty((emb.shape[0], num_frames, emb.shape[2]), np.float32)
    for i, t in enumerate(dst):
        lo = int(np.floor(t))
        hi = min(lo + 1, load_frames - 1)
        w = t - lo
        out[:, i] = (1 - w) * emb[:, lo] + w * emb[:, hi]
    return out


def _dense(sd, prefix):
    out = {"kernel": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _var_attention(sd, prefix, fused):
    p = {"qkv": _dense(sd, prefix + ".qkv"),
         "proj": _dense(sd, prefix + ".proj")}
    if fused and prefix + ".qkv_text_i2t.weight" in sd:
        p.update({
            "qkv_text_i2t": _dense(sd, prefix + ".qkv_text_i2t"),
            "qkv_i2t": _dense(sd, prefix + ".qkv_i2t"),
            "proj_i2t": _dense(sd, prefix + ".proj_i2t"),
            "norm_i2t_i": _ln(sd, prefix + ".norm_i2t_i"),
        })
    return p


def map_video_model(sd: Dict[str, np.ndarray], depth: int = 12,
                    num_unfused: int = 6, prefix: str = "video_model"):
    """Reference SpaceTimeTransformer names -> SpaceTimeViT parameter tree."""
    conv_w = sd[f"{prefix}.patch_embed.proj.weight"]  # [O, I, kh, kw]
    p = {
        "patch_embed": {"kernel": conv_w.transpose(2, 3, 1, 0),
                        "bias": sd[f"{prefix}.patch_embed.proj.bias"]},
        "cls_token": sd[f"{prefix}.cls_token"],
        "pos_embed": sd[f"{prefix}.pos_embed"],
        "temporal_embed": sd[f"{prefix}.temporal_embed"],
        "norm": _ln(sd, f"{prefix}.norm"),
    }
    for i in range(depth):
        bp = f"{prefix}.blocks.{i}"
        fused = i >= num_unfused
        blk = {
            "norm1": _ln(sd, bp + ".norm1"),
            "norm2": _ln(sd, bp + ".norm2"),
            "norm3": _ln(sd, bp + ".norm3"),
            "attn": _var_attention(sd, bp + ".attn", fused),
            "timeattn": _var_attention(sd, bp + ".timeattn", False),
            "mlp": {"fc1": _dense(sd, bp + ".mlp.fc1"),
                    "fc2": _dense(sd, bp + ".mlp.fc2")},
        }
        if fused and bp + ".attn.alpha_i2t" in sd:
            blk["attn"]["alpha_i2t"] = sd[bp + ".attn.alpha_i2t"]
        p[f"blocks_{i}"] = blk
    return p


def map_text_model(sd: Dict[str, np.ndarray], num_layers: int = 12,
                   num_unfused: int = 6, prefix: str = "text_model"):
    """Reference (vendored HF) RoBERTa names -> TextEncoder parameter tree."""
    emb = f"{prefix}.embeddings"
    p = {"embeddings": {
        "word_embeddings": {
            "embedding": sd[f"{emb}.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd[f"{emb}.position_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd[f"{emb}.token_type_embeddings.weight"]},
        "LayerNorm": _ln(sd, f"{emb}.LayerNorm"),
    }}
    for i in range(num_layers):
        lp = f"{prefix}.encoder.layer.{i}"
        layer = {
            "attention": {
                "query": _dense(sd, lp + ".attention.self.query"),
                "key": _dense(sd, lp + ".attention.self.key"),
                "value": _dense(sd, lp + ".attention.self.value"),
                "out_dense": _dense(sd, lp + ".attention.output.dense"),
            },
            "attention_LayerNorm": _ln(sd, lp + ".attention.output.LayerNorm"),
            "intermediate": _dense(sd, lp + ".intermediate.dense"),
            "output": _dense(sd, lp + ".output.dense"),
            "output_LayerNorm": _ln(sd, lp + ".output.LayerNorm"),
        }
        if i >= num_unfused \
                and lp + ".crossattention_t2i.self.query.weight" in sd:
            cp = lp + ".crossattention_t2i"
            layer["crossattention_t2i"] = {
                "query": _dense(sd, cp + ".self.query"),
                "key": _dense(sd, cp + ".self.key"),
                "value": _dense(sd, cp + ".self.value"),
                "out_dense": _dense(sd, cp + ".output.dense"),
            }
            layer["alpha_t2i"] = sd[lp + ".alpha_t2i"]
        p[f"layer_{i}"] = layer
    return p


def map_projection(sd, prefix):
    """minimal: Sequential [0,2,4] Linears; small: single Linear (index 0/1)."""
    if f"{prefix}.0.weight" in sd and f"{prefix}.2.weight" in sd:
        return {"fc0": _dense(sd, f"{prefix}.0"),
                "fc1": _dense(sd, f"{prefix}.2"),
                "fc2": _dense(sd, f"{prefix}.4")}
    for idx in (0, 1):  # 'small': vid_proj Linear at 0, txt_proj at 1 (after ReLU)
        if f"{prefix}.{idx}.weight" in sd:
            return {"fc0": _dense(sd, f"{prefix}.{idx}")}
    return None


class _RecordingDict(dict):
    """Tracks which checkpoint keys the mappers consumed, so strict imports
    can fail on reference weights that would silently stay random."""

    def __init__(self, base):
        super().__init__(base)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


# Non-parameter buffers the published state_dict carries (HF registers them
# on RobertaEmbeddings); no parameter takes them.
_IGNORABLE_BUFFER_SUFFIXES = ("position_ids", "token_type_ids")


def _map_reference(sd: _RecordingDict) -> Dict:
    """The whole reference state_dict -> the flax-shaped nested tree."""
    mapped: Dict = {}
    if "video_model.cls_token" in sd:
        depth = 1 + max(int(k.split(".")[2]) for k in sd
                        if k.startswith("video_model.blocks."))
        fused_idx = [int(k.split(".")[2]) for k in sd
                     if k.startswith("video_model.blocks.")
                     and "alpha_i2t" in k]
        num_unfused = min(fused_idx) if fused_idx else depth
        mapped["video_model"] = map_video_model(sd, depth, num_unfused)
    if "text_model.embeddings.word_embeddings.weight" in sd:
        n_layers = 1 + max(int(k.split(".")[3]) for k in sd
                           if k.startswith("text_model.encoder.layer."))
        fused_idx = [int(k.split(".")[3]) for k in sd
                     if "crossattention_t2i.self.query.weight" in k]
        num_unfused = min(fused_idx) if fused_idx else n_layers
        mapped["text_model"] = map_text_model(sd, n_layers, num_unfused)
    for proj in ("txt_proj", "vid_proj"):
        m = map_projection(sd, proj)
        if m is not None:
            mapped[proj] = m
    # model-level fused components (model.py:145-177)
    if "cls_token" in sd:
        mapped["cls_token"] = sd["cls_token"]
    if "norm.weight" in sd:
        mapped["norm"] = _ln(sd, "norm")
    for name in ("cross_modal_text_transform", "cross_modal_video_transform"):
        if f"{name}.weight" in sd:
            mapped[name] = _dense(sd, name)
    for name in ("cross_modal_text_pooler", "cross_modal_video_pooler"):
        if f"{name}.dense.weight" in sd:
            mapped[name] = {"dense": _dense(sd, f"{name}.dense")}
    if "itm_score.fc.weight" in sd:
        mapped["itm_score"] = {"fc": _dense(sd, "itm_score.fc")}
    if "mlm_score.transform.dense.weight" in sd:
        mapped["mlm_score"] = {
            "transform_dense": _dense(sd, "mlm_score.transform.dense"),
            "transform_LayerNorm": _ln(sd, "mlm_score.transform.LayerNorm"),
            "decoder": {"kernel": sd["mlm_score.decoder.weight"].T},
            "bias": sd["mlm_score.bias"],
        }
    return mapped


def import_reference_checkpoint(
    sd: Dict[str, np.ndarray],
    state_dict: Mapping[str, torch.Tensor],
    num_frames: Optional[int] = None,
    temporal_fix: str = "bilinear",
    strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Overlay reference weights onto a model's `state_dict`.

    Returns (new_state_dict, report): float32 CPU tensors under the port's
    names, every entry of `state_dict` present (those the checkpoint lacks
    keep their values), ready for `load_state_dict`; the report lists the
    imported, skipped, missing and unused names as flax paths joined with
    '.', as the JAX package's importer reports them.
    """
    sd = _RecordingDict(strip_module_prefix(sd))
    if num_frames is not None and "video_model.temporal_embed" in sd:
        sd["video_model.temporal_embed"] = inflate_temporal_embed(
            sd["video_model.temporal_embed"], num_frames, temporal_fix)

    flat_mapped = dict(_flatten(_map_reference(sd)))
    # flax path -> (the port's name, the parameter's shape in flax layout)
    targets = {}
    for name, tensor in state_dict.items():
        path = flax_path(name, tensor.dim())
        shape = tuple(tensor.shape)
        if path[-1] == "kernel" and tensor.dim() == 2:
            shape = shape[::-1]
        targets[path] = (name, shape)

    out = {name: t.detach().to("cpu", torch.float32)
           for name, t in state_dict.items()}
    imported, skipped, missing = [], [], []
    for path, value in flat_mapped.items():
        if path not in targets:
            skipped.append(".".join(path))
            continue
        name, shape = targets[path]
        value = np.asarray(value)
        if value.shape != shape:
            if value.size != int(np.prod(shape)):
                skipped.append(f"{'.'.join(path)} (shape {value.shape} vs "
                               f"{shape})")
                continue
            value = value.reshape(shape)
        if path[-1] == "kernel" and value.ndim == 2:
            value = value.T  # back to the port's [out, in]
        out[name] = torch.from_numpy(
            np.ascontiguousarray(value, dtype=np.float32).copy())
        imported.append(".".join(path))
    for path in targets:
        if path not in flat_mapped:
            missing.append(".".join(path))
    unused = [k for k in sd if k not in sd.used
              and not k.endswith(_IGNORABLE_BUFFER_SUFFIXES)]
    if strict and (skipped or missing or unused):
        raise ValueError(
            f"import mismatch: skipped={skipped[:5]} missing={missing[:5]} "
            f"unused_checkpoint_keys={unused[:5]}")
    report = {"imported": imported, "skipped": skipped,
              "missing_in_checkpoint": missing,
              "unused_checkpoint_keys": unused}
    return out, report
