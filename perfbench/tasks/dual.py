"""The dual-encoder fine-tune (both towers, NormSoftmax or a max-margin
loss): the port's `EgoVLPv2` and its AdamW groups, as
`tasks/retrieval.py::build_dual` assembles them, and
`tasks/retrieval.py::make_dual_train_step`. The reference is
`perfbench/reference/dual.py`; the weights follow EgoVLPv2's rules
(`perfbench/weights.py::init_kind`)."""

from perfbench import bounds, flops, weights

REFERENCE = "dual"
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
    from egovlpv2_torch.tasks.retrieval import make_dual_train_step
    return make_dual_train_step(model, cfg, optimizer, scheduler, generator)


def step_flops(cfg: dict, rows: int, traffic: dict) -> dict:
    return flops.dual(cfg, rows)


def step_calls(cfg: dict, rows: int, traffic: dict) -> list:
    return bounds.dual_calls(cfg, rows)
