"""Tokenizer adapter (the port's own copy of `Tokenizer` in
`egovlpv2_tpu/data/loader.py`): a Hugging Face tokenizer when one can be
loaded from the local cache, else a deterministic hash tokenizer with
RoBERTa's special-token ids, so that runs without the vocabulary files
still exercise the whole pipeline. numpy only."""

from __future__ import annotations

import zlib
from typing import Dict, Optional, Sequence

import numpy as np


class Tokenizer:
    """The pretrain recipe tokenizes with roberta-base at max_length 15
    (`trainer_egoclip.py:120`); fine-tunes use 30 (`trainer_epic.py:134`)."""

    # RoBERTa special ids (roberta-base tokenizer config)
    BOS, PAD, EOS, MASK, VOCAB = 0, 1, 2, 50264, 50265

    def __init__(self, name_or_path: str = "roberta-base", max_len: int = 15,
                 allow_fallback: bool = True, vocab_cap: Optional[int] = None):
        self.max_len = max_len
        self.vocab_cap = vocab_cap  # clamp ids for small-vocab smoke models
        self._tok = None
        try:
            from transformers import AutoTokenizer

            try:
                # cache-only first: no network retry loops when offline
                self._tok = AutoTokenizer.from_pretrained(
                    name_or_path, local_files_only=True)
            except Exception:
                self._tok = AutoTokenizer.from_pretrained(name_or_path)
        except Exception:
            if not allow_fallback:
                raise

    def _fallback(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        L = self.max_len
        ids = np.full((len(texts), L), self.PAD, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for r, text in enumerate(texts):
            toks = [self.BOS]
            for w in str(text).split():
                if len(toks) >= L - 1:
                    break
                # stable word -> id, avoiding the special ids
                toks.append(4 + zlib.crc32(w.lower().encode()) % (self.MASK - 8))
            toks.append(self.EOS)
            ids[r, : len(toks)] = toks[:L]
            mask[r, : len(toks)] = 1
        return {"text_ids": ids, "text_mask": mask}

    def _cap(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.vocab_cap is not None and self.vocab_cap < self.VOCAB:
            ids = out["text_ids"]
            out["text_ids"] = np.where(
                ids < self.vocab_cap, ids, 4 + ids % max(self.vocab_cap - 4, 1)
            ).astype(np.int32)
        return out

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        if self._tok is None:
            return self._cap(self._fallback(texts))
        enc = self._tok(
            list(texts), padding="max_length", truncation=True,
            max_length=self.max_len, return_tensors="np",
        )
        return self._cap({
            "text_ids": enc["input_ids"].astype(np.int32),
            "text_mask": enc["attention_mask"].astype(np.int32),
        })
