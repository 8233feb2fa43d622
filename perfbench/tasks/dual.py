"""The dual-encoder fine-tune (both towers, NormSoftmax or a max-margin
loss): the port's `tasks/retrieval.py::make_dual_train_step`, as
`build_dual` assembles it."""

from perfbench import bounds, flops

REFERENCE = "dual"


def make_step(model, cfg, optimizer, scheduler, generator, mining):
    from egovlpv2_torch.tasks.retrieval import make_dual_train_step
    return make_dual_train_step(model, cfg, optimizer, scheduler, generator)


def step_flops(cfg: dict, rows: int, traffic: dict) -> dict:
    return flops.dual(cfg, rows)


def step_calls(cfg: dict, rows: int, traffic: dict) -> list:
    return bounds.dual_calls(cfg, rows)
