"""Offline video preprocessing tools (ffmpeg-based, multi-process): the
port's copy of `egovlpv2_tpu/data/preprocess.py`.

Capability-parity targets:
  * `EgoVLPv2/utils/video_resize.py:17-31` — resize every video to height
    256 (keep aspect, even width), parallel over a process pool;
  * `EgoVLPv2/utils/video_chunk.py:27-67` — split each video into <=600 s
    chunks saved as <uid>/<i>.mp4 (the layout the EgoClip reader expects);
  * `EgoVLPv2/utils/charades_meta.py` — metadata CSV generation for
    Charades-Ego train/val narration windows.

ffmpeg is invoked as a subprocess and is never required: callers check
`ffmpeg_available()` first (not every machine has it).
"""

from __future__ import annotations

import csv
import os
import shutil
import subprocess
from multiprocessing import Pool
from typing import Iterable, List, Tuple

CHUNK_SEC = 600


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def resize_video(in_path: str, out_path: str, height: int = 256) -> bool:
    """Scale to the given height, keep aspect (even width), copy audio."""
    if os.path.exists(out_path):
        return True
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    cmd = [
        "ffmpeg", "-y", "-i", in_path,
        "-filter:v", f'scale=trunc(oh*a/2)*2:{height}',
        "-c:a", "copy", out_path,
    ]
    return subprocess.call(cmd, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL) == 0


def resize_videos(pairs: Iterable[Tuple[str, str]], height: int = 256,
                  workers: int = 8):
    with Pool(workers) as pool:
        pool.starmap(resize_video, [(i, o, height) for i, o in pairs])


def video_duration(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    rate = cap.get(cv2.CAP_PROP_FPS)
    frames = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return frames / rate if rate else 0.0


def chunk_video(in_path: str, out_dir: str, uid: str,
                dur_limit: float = CHUNK_SEC) -> int:
    """Split into <uid>/<i>.mp4 chunks of <= dur_limit seconds
    (video_chunk.py:27-67). Returns the number of chunks written."""
    out_uid_dir = os.path.join(out_dir, uid)
    os.makedirs(out_uid_dir, exist_ok=True)
    duration = video_duration(in_path)
    if duration <= dur_limit:
        shutil.copyfile(in_path, os.path.join(out_uid_dir, "0.mp4"))
        return 1
    num_seg = int(duration // dur_limit)
    s1, s2, n = 0.0, dur_limit, 0
    while n <= num_seg:
        out_path = os.path.join(out_uid_dir, f"{n}.mp4")
        subprocess.call(
            ["ffmpeg", "-y", "-i", in_path, "-ss", str(s1), "-to", str(s2),
             "-async", "1", out_path],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        s1, s2 = s2, min(s2 + dur_limit, duration)
        n += 1
    return n


def chunk_videos(items: Iterable[Tuple[str, str]], out_dir: str,
                 dur_limit: float = CHUNK_SEC, workers: int = 8):
    """items: (in_path, uid) pairs."""
    with Pool(workers) as pool:
        pool.starmap(chunk_video,
                     [(p, out_dir, uid, dur_limit) for p, uid in items])


def write_charades_meta(annotations: List[dict], out_csv: str,
                        egocentric_only: bool = True):
    """Charades-Ego metadata CSV (id, narration/actions, t_start, t_end)."""
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["id", "narration", "actions", "t_start", "t_end"]
        )
        writer.writeheader()
        for ann in annotations:
            if egocentric_only and not str(ann.get("id", "")).endswith("EGO"):
                continue
            writer.writerow({
                "id": ann["id"],
                "narration": ann.get("script", ann.get("narration", "")),
                "actions": ann.get("actions", ""),
                "t_start": ann.get("t_start", ""),
                "t_end": ann.get("t_end", ""),
            })
