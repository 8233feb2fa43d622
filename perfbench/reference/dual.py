"""The reference of the dual-encoder fine-tune: EgoVLPv2's plain model
(`model.py`), NormSoftmax over the two towers, and the recipe's AdamW
groups (`train.py`)."""

from perfbench.reference.model import EgoVLPv2
from perfbench.reference.train import dual_loss as loss, group_of

__all__ = ["build", "loss", "group_of"]


def build(model_cfg: dict, precision) -> EgoVLPv2:
    return EgoVLPv2(model_cfg, precision)
