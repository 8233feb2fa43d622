"""EgoMQ annotation conversion: official Ego4D moments -> clip annotations
(a copy of `egovlpv2_tpu/downstream/mq_data.py`).

Capability-parity target: `EgoMQ/Convert_annotations.py` — flattens the
video-level `moments_{train,val,test}.json` releases into the per-clip
annotation table consumed by `EgoMQFeatureDataset` (and the reference's
`Evaluation/ego4d/annot/clip_annotations.json`): one record per clip_uid
with the parent-video span, the video duration/feature fps, and the clip's
primary moment labels; train/val clips with zero annotations are dropped.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

log = logging.getLogger(__name__)

JsonLike = Union[str, Dict]


def _load(obj: JsonLike) -> Dict:
    if isinstance(obj, str):
        with open(obj) as f:
            return json.load(f)
    return obj


def _feature_len(feature_dir: str, clip_uid: str) -> Optional[int]:
    """Frames in the extracted feature dump (.npy preferred, .pt fallback)."""
    base = os.path.join(feature_dir, clip_uid)
    if os.path.exists(base + ".npy"):
        return int(np.load(base + ".npy", mmap_mode="r").shape[0])
    if os.path.exists(base + ".pt"):
        try:
            import torch

            return int(torch.load(base + ".pt", map_location="cpu").shape[0])
        except ImportError:
            return None
    return None


def convert_moment_annotations(
    moment_jsons: Sequence[JsonLike],
    video_info: JsonLike,
    feature_dir: Optional[str] = None,
) -> Dict[str, Dict]:
    """Build {clip_uid: clip record} from the official releases.

    moment_jsons: the moments_train/val/test_unannotated release dicts or
    paths ({"videos": [{video_uid, split, clips: [...]}]}).
    video_info: the ego4d.json metadata ({"videos": [{video_uid,
    duration_sec}]}) supplying each video's canonical duration.
    feature_dir: when given, videos whose first clip has no extracted
    features are skipped (Convert_annotations.py:52-57) and `fps` is
    feature_frames / duration; without it fps is omitted (the dataset
    recomputes it from the feature file at load time).
    """
    durations = {
        v["video_uid"]: float(v["duration_sec"])
        for v in _load(video_info)["videos"]
    }

    clips_out: Dict[str, Dict] = {}
    for release in moment_jsons:
        for video in _load(release)["videos"]:
            vid = video["video_uid"]
            clips = video.get("clips") or []
            if not clips:
                continue
            if vid not in durations:
                log.warning("video %s missing from the info json", vid)
                continue
            duration = durations[vid]
            fps = None
            if feature_dir is not None:
                n = _feature_len(feature_dir, clips[0]["clip_uid"])
                if n is None:
                    log.warning("%s features do not exist!", vid)
                    continue
                fps = n / duration
            for clip in clips:
                cid = clip["clip_uid"]
                rec = clips_out.setdefault(cid, {
                    "video_id": vid,
                    "clip_id": cid,
                    "parent_start_sec": clip["video_start_sec"],
                    "parent_end_sec": clip["video_end_sec"],
                    "v_duration": duration,
                    "subset": video["split"],
                    "annotations": [],
                })
                if fps is not None:
                    rec["fps"] = fps
                if video["split"] == "test":
                    continue
                for annot in clip.get("annotations", []):
                    # each annotator tags the same moments; keep primaries
                    rec["annotations"] += [
                        label for label in annot.get("labels", [])
                        if label.get("primary")
                    ]

    # train/val clips with no surviving annotations are unusable
    for cid in [c for c, v in clips_out.items()
                if v["subset"] != "test" and not v["annotations"]]:
        log.warning("NO annotations: clip %s", cid)
        del clips_out[cid]
    return clips_out


def write_clip_annotations(
    out_path: str,
    moment_jsons: Sequence[JsonLike],
    video_info: JsonLike,
    feature_dir: Optional[str] = None,
) -> Dict[str, int]:
    """Convert and write the clip-annotation json; returns split counts."""
    clips = convert_moment_annotations(moment_jsons, video_info, feature_dir)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(clips, f)
    counts: Dict[str, int] = {}
    for v in clips.values():
        counts[v["subset"]] = counts.get(v["subset"], 0) + 1
    log.info("clip annotations -> %s (%s)", out_path, counts)
    return counts
