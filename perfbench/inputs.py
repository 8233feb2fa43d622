"""The one generator of traffic: a pool of distinct training batches drawn
on the device from a seed, as a traffic file's parameters say.

A traffic file (`perfbench/traffic/<name>.json`) holds:
  pool_batches    how many distinct batches the window cycles over;
  parts           which parts a batch has: "video" (normal frames
                  [B, F, H, W, C], float32, normalised as the host would
                  hand them), "text" (token ids and a padding mask, one
                  length a row drawn uniformly from text_len_min to the
                  configuration's max_text_len), "mlm" (the text's masked
                  copy and labels at the configuration's mlm_prob: 80%
                  <mask>, 10% a random token, 10% kept, special tokens never
                  chosen) and "noun_verb" (multi-hot noun and verb vectors);
  text_len_min    the shortest text, tokens <s> and </s> included;
  noun_dim, verb_dim, noun_rate, verb_rate, noun_first, verb_first
                  the multi-hot widths, the chance of each entry being on,
                  and the range of the one entry each row always has.
Rows, frames, the image size and the text cap come from the configuration.
Ids follow RoBERTa's: <s> 0, <pad> 1, </s> 2, <mask> 50264.
"""

from __future__ import annotations

from typing import Dict, List

import torch

BOS, PAD, EOS, MASK = 0, 1, 2, 50264
SPECIAL = (0, 1, 2, 3, 50264)


def make_pool(cfg: dict, traffic: dict, rows: int, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """`traffic["pool_batches"]` batches of `rows` rows each; `cfg` is the
    configuration file's content."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [_batch(cfg, traffic, rows, gen, device)
            for _ in range(traffic["pool_batches"])]


def _batch(cfg, traffic, rows, gen, device) -> Dict[str, torch.Tensor]:
    v, t = cfg["model"]["video"], cfg["model"]["text"]
    parts = traffic["parts"]
    out = {}
    if "video" in parts:
        out["video"] = torch.randn(
            (rows, v["num_frames"], v["img_size"], v["img_size"],
             v["in_chans"]), generator=gen, device=device)
    if "text" in parts:
        length = cfg["max_text_len"]
        vocab = t["vocab_size"]
        lens = torch.randint(traffic["text_len_min"], length + 1, (rows, 1),
                             generator=gen, device=device)
        ids = torch.randint(4, vocab - 2, (rows, length), generator=gen,
                            device=device)
        pos = torch.arange(length, device=device)[None, :]
        ids[:, 0] = BOS
        ids = torch.where(pos == lens - 1, EOS, ids)
        ids = torch.where(pos >= lens, PAD, ids)
        out["text_ids"] = ids
        out["text_mask"] = (pos < lens).to(torch.int32)
        if "mlm" in parts:
            special = torch.isin(ids, torch.tensor(SPECIAL, device=device))
            u = torch.rand((3, rows, length), generator=gen, device=device)
            chosen = (u[0] < cfg["mlm_prob"]) & ~special
            to_mask = chosen & (u[1] < 0.8)
            to_random = chosen & ~to_mask & (u[2] < 0.5)
            random = torch.randint(0, vocab, (rows, length), generator=gen,
                                   device=device)
            mlm = torch.where(to_mask, min(MASK, vocab - 1), ids)
            out["text_mlm_ids"] = torch.where(to_random, random, mlm)
            out["text_mlm_labels"] = torch.where(chosen, ids, -100)
    if "noun_verb" in parts:
        for key in ("noun", "verb"):
            dim = traffic[f"{key}_dim"]
            hot = (torch.rand((rows, dim), generator=gen, device=device)
                   < traffic[f"{key}_rate"]).float()
            first = torch.randint(0, min(traffic[f"{key}_first"], dim),
                                  (rows,), generator=gen, device=device)
            hot[torch.arange(rows, device=device), first] = 1.0
            out[f"{key}_vec"] = hot
    return out
