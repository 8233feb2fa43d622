"""Host-side MLM masking collator (numpy); the port's own copy of
`egovlpv2_tpu/data/mlm.py`: the same draws from the same `Generator`.

Capability-parity target: HF `DataCollatorForLanguageModeling` as used at
`EgoVLPv2/trainer/trainer_egoclip.py:79,123-133`: select 15% of non-special
tokens; of those 80% -> <mask>, 10% -> random vocab token, 10% -> unchanged;
labels are -100 everywhere else.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# roberta-base special ids: <s>=0, <pad>=1, </s>=2, <mask>=50264
ROBERTA_SPECIAL_IDS = (0, 1, 2, 3, 50264)
ROBERTA_MASK_ID = 50264
ROBERTA_VOCAB = 50265


def mask_tokens(
    input_ids: np.ndarray,
    rng: np.random.Generator,
    mlm_prob: float = 0.15,
    mask_id: int = ROBERTA_MASK_ID,
    vocab_size: int = ROBERTA_VOCAB,
    special_ids: Sequence[int] = ROBERTA_SPECIAL_IDS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (mlm_input_ids, mlm_labels), both shaped like input_ids."""
    ids = np.array(input_ids, dtype=np.int64, copy=True)
    labels = ids.copy()

    special = np.isin(ids, np.asarray(special_ids))
    prob = np.full(ids.shape, mlm_prob)
    prob[special] = 0.0
    masked = rng.random(ids.shape) < prob
    labels[~masked] = -100

    # 80% -> <mask>
    replace = (rng.random(ids.shape) < 0.8) & masked
    ids[replace] = mask_id
    # 10% (half of the remaining 20%) -> random token
    randomize = (rng.random(ids.shape) < 0.5) & masked & ~replace
    ids[randomize] = rng.integers(0, vocab_size, ids.shape)[randomize]
    # remaining 10%: keep original
    return ids, labels
