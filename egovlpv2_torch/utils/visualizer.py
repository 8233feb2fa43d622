"""HTML pages of retrieval results (port of
`egovlpv2_tpu/utils/visualizer.py`, numpy and strings only): a `web/`
directory with a page an epoch that lists each text query and its top-k
videos, and an `index.html` that links the pages (the original code's
`utils/visualizer.py:14` and `utils/html.py`, without dominate).
"""

from __future__ import annotations

import html
import os
from typing import Sequence

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ border: 1px solid #ccc; padding: 6px 10px; font-size: 14px; }}
tr.hit td {{ background: #e7f7e7; }}
tr.miss td {{ background: #fbecec; }}
video {{ max-width: 280px; }}
</style></head><body>
<h1>{title}</h1>
{body}
</body></html>
"""


_NAME = "retrieval"
_TOP_K = 5


class RetrievalVisualizer:
    def __init__(self, web_dir: str):
        self.web_dir = web_dir
        os.makedirs(web_dir, exist_ok=True)

    def write_epoch(self, epoch: int, queries: Sequence[str],
                    sims: np.ndarray, gt_indices: Sequence[int]) -> str:
        """The page of `epoch`: each query's top-5 videos of `sims`
        [num_queries, num_videos] and the rank of its ground truth
        `gt_indices[i]`."""
        rows = ["<table><tr><th>#</th><th>query</th><th>top retrievals"
                "</th><th>gt rank</th></tr>"]
        order = np.argsort(-sims, axis=1)
        for i, q in enumerate(queries):
            cells = []
            for j in order[i, :_TOP_K]:
                mark = " ✓" if j == gt_indices[i] else ""
                cells.append(f"video {j} ({sims[i, j]:.3f}){mark}")
            rank = int(np.where(order[i] == gt_indices[i])[0][0]) + 1
            cls = "hit" if rank <= _TOP_K else "miss"
            rows.append(
                f'<tr class="{cls}"><td>{i}</td><td>{html.escape(str(q))}</td>'
                f"<td>{' | '.join(cells)}</td><td>{rank}</td></tr>"
            )
        rows.append("</table>")
        path = os.path.join(self.web_dir, f"{_NAME}_epoch{epoch}.html")
        with open(path, "w") as f:
            f.write(_PAGE.format(title=f"{_NAME} epoch {epoch}",
                                 body="\n".join(rows)))
        self._write_index()
        return path

    def _write_index(self):
        pages = sorted(p for p in os.listdir(self.web_dir) if p.endswith(".html")
                       and p != "index.html")
        links = "\n".join(f'<p><a href="{p}">{p}</a></p>' for p in pages)
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(_PAGE.format(title="retrieval results", body=links))
