"""Pre-training (EgoNCE + MLM + itm_weight * ITM with mined negatives): the
port's `EgoVLPv2` and its six AdamW groups, as
`tasks/pretrain.py::build_pretrain` assembles them, and
`train/step.py::make_train_step` with its default loss, `pretrain_loss_fn`.
The reference is `perfbench/reference/pretrain.py`; the weights follow
EgoVLPv2's rules (`perfbench/weights.py::init_kind`)."""

from perfbench import bounds, flops, weights

REFERENCE = "pretrain"
init_kind = weights.init_kind


def program_config(path: str):
    from egovlpv2_torch.core.config import load_train_config
    return load_train_config(path)


def build_model(cfg, device):
    from egovlpv2_torch.models.egovlp import EgoVLPv2
    return EgoVLPv2(cfg.model, device=device)


def make_optimizer(cfg, model):
    from egovlpv2_torch.train import optimizer
    return optimizer.make_optimizer(cfg.optim, model)


def make_step(model, cfg, optimizer, scheduler, generator, mining):
    from egovlpv2_torch.train.step import make_train_step
    return make_train_step(model, cfg, optimizer, scheduler, generator,
                           mining_generator=mining)


def step_flops(cfg: dict, rows: int, traffic: dict) -> dict:
    return flops.pretrain(cfg, rows, traffic["noun_dim"], traffic["verb_dim"])


def step_calls(cfg: dict, rows: int, traffic: dict) -> list:
    return bounds.pretrain_calls(cfg, rows)
