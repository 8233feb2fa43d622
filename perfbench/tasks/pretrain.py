"""Pre-training (EgoNCE + MLM + itm_weight * ITM with mined negatives): the
port's `train/step.py::make_train_step` with its default loss,
`pretrain_loss_fn`, as `tasks/pretrain.py::build_pretrain` assembles it."""

from perfbench import bounds, flops

REFERENCE = "pretrain"


def make_step(model, cfg, optimizer, scheduler, generator, mining):
    from egovlpv2_torch.train.step import make_train_step
    return make_train_step(model, cfg, optimizer, scheduler, generator,
                           mining_generator=mining)


def step_flops(cfg: dict, rows: int, traffic: dict) -> dict:
    return flops.pretrain(cfg, rows, traffic["noun_dim"], traffic["verb_dim"])


def step_calls(cfg: dict, rows: int, traffic: dict) -> list:
    return bounds.pretrain_calls(cfg, rows)
