"""`graph_replay_share.train` on a synthetic ring of the program's spans:
the share of the window's steps that hold a replay span, and nothing
where the program records no such span or the ring lost a window step."""

from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace as Context

import pytest

from perfbench import manifest, program_spans

Span = namedtuple("Span", "id name parent step start end thread")

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns
EAGER = ["egovlpv2.step", "egovlpv2.step.zero_grad", "egovlpv2.step.put",
         "egovlpv2.step.forward", "egovlpv2.step.backward",
         "egovlpv2.step.optimizer"]
REPLAY = ["egovlpv2.step", "egovlpv2.step.put", "egovlpv2.step.replay"]


def make_ring(kinds):
    """One step a kind, 10 ms apart from 0; each span 1 ms."""
    spans, i = [], 1
    for step, names in enumerate(kinds, start=1):
        head = i
        for j, name in enumerate(names):
            t = (10 * (step - 1) + j) * MS
            spans.append(Span(i, name, None if j == 0 else head, step, t,
                              t + MS, 7))
            i += 1
    return spans


def read(kinds, steps=None):
    ctx = Context(window={"t0": 0.0, "t1": 1.0,
                          "steps": len(kinds) if steps is None else steps})
    return manifest.reader(ROOT, "graph_replay_share.train").read(ctx)


@pytest.mark.parametrize("kinds, share", [
    ([EAGER] * 4, 0.0),
    ([REPLAY] * 4, 100.0),
    ([EAGER, REPLAY, REPLAY, REPLAY], 75.0),
], ids=["all_eager", "all_replay", "mixed"])
def test_share_of_the_window_steps_replayed(monkeypatch, kinds, share):
    monkeypatch.setattr(program_spans, "ring", lambda: make_ring(kinds))
    assert read(kinds) == pytest.approx(share)


def test_nothing_where_a_window_step_left_the_ring(monkeypatch):
    kinds = [REPLAY] * 3
    monkeypatch.setattr(program_spans, "ring", lambda: make_ring(kinds))
    assert read(kinds, steps=4) is None


def test_nothing_from_a_program_without_the_replay_span(monkeypatch):
    from egovlpv2_torch.utils import logging as program_logging

    kinds = [EAGER] * 4
    monkeypatch.setattr(program_spans, "ring", lambda: make_ring(kinds))
    monkeypatch.delattr(program_logging, "REPLAY")
    assert read(kinds) is None
