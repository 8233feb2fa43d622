"""The reference of the pre-training step: EgoVLPv2's plain model
(`model.py`), EgoNCE + MLM + itm_weight * ITM with mined negatives, and the
recipe's six AdamW groups (`train.py`)."""

from perfbench.reference.model import EgoVLPv2
from perfbench.reference.train import group_of, pretrain_loss as loss

__all__ = ["build", "loss", "group_of"]


def build(model_cfg: dict, precision) -> EgoVLPv2:
    return EgoVLPv2(model_cfg, precision)
