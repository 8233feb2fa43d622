"""EgoNLQ data generation: Ego4D NLQ json -> flattened query records (a
copy of `egovlpv2_tpu/downstream/nlq_data.py`, numpy only).

Capability-parity target: `EgoNLQ/utils/data_gen.py` (EpisodicNLQProcessor:
35-150, gen_or_load_dataset:266): flatten (video, clip, annotation, query)
into one record per language query with exact start/end seconds, and map
times to feature-window indices with `nlq_eval.time_to_index`. The fused
per-query features these records point to are written by
`egovlpv2_torch.tasks.extract.extract_nlq_features`, which reads each clip
once for all of its queries.
"""

from __future__ import annotations

import json
from typing import Dict, List

from egovlpv2_torch.downstream.nlq_eval import time_to_index


def load_nlq_annotations(ann_file: str, is_annotated: bool = True) -> List[Dict]:
    """Flatten the official Ego4D NLQ json into per-query records."""
    with open(ann_file) as f:
        anno = json.load(f)
    records = []
    for video in anno["videos"]:
        for clip in video["clips"]:
            clip_start = float(clip["video_start_sec"])
            clip_end = float(clip["video_end_sec"])
            duration = clip_end - clip_start
            for ann in clip["annotations"]:
                for qi, query in enumerate(ann.get("language_queries", [])):
                    if query is None or "query" not in query or not query["query"]:
                        continue
                    rec = {
                        "video_uid": video["video_uid"],
                        "clip_uid": clip["clip_uid"],
                        "annotation_uid": ann["annotation_uid"],
                        "query_idx": qi,
                        "query": str(query["query"]).strip().lower(),
                        "duration": duration,
                    }
                    if is_annotated and "clip_start_sec" in query:
                        rec["s_time"] = float(query["clip_start_sec"])
                        rec["e_time"] = float(query["clip_end_sec"])
                    records.append(rec)
    return records


def attach_feature_indices(records: List[Dict], num_windows_by_clip: Dict[str, int]):
    """Map gt seconds to feature-window span indices (data_gen + data_util)."""
    out = []
    for rec in records:
        n = num_windows_by_clip.get(rec["clip_uid"])
        if n is None:
            continue
        rec = dict(rec, num_windows=n)
        if "s_time" in rec:
            s_ind, e_ind, _ = time_to_index(
                rec["s_time"], rec["e_time"], n, rec["duration"]
            )
            rec["s_ind"], rec["e_ind"] = int(s_ind), int(e_ind)
        out.append(rec)
    return out

