"""The host spans of the port's training step (`utils/logging.py::Spans`):
nesting and step numbers per thread, the ring's bound, `record_function`
ranges only under an active profiler, the spans a pretrain step records,
that recording them changes nothing the step computes, and the CLI's
means of them in its log rows."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from egovlpv2_torch import cli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.utils import logging as tlogging
from egovlpv2_torch.utils.logging import STEP, SPANS, SpanMeans, Spans

STEP_SPANS = [
    STEP,
    "egovlpv2.step.zero_grad",
    "egovlpv2.step.put",
    "egovlpv2.step.forward",
    "egovlpv2.forward.egonce",
    "egovlpv2.forward.video_unfused",
    "egovlpv2.forward.mlm",
    "egovlpv2.forward.itm_mining",
    "egovlpv2.forward.itm",
    "egovlpv2.step.backward",
    "egovlpv2.step.optimizer",
    "egovlpv2.optimizer.grad_sync",
    "egovlpv2.optimizer.adamw",
]


def test_spans_nest_per_thread_with_their_step():
    rec = Spans(capacity=64)
    threads = set()

    def other_thread():
        with rec.span("feeder.read"):
            with rec.span("feeder.decode"):
                pass
        threads.add(threading.get_native_id())

    with rec.span("loop.wait"):
        pass
    for _ in range(2):
        with rec.span(STEP):
            with rec.span("a"):
                t = threading.Thread(target=other_thread)
                t.start()
                t.join()
                with rec.span("b"):
                    pass
    got = rec.records()
    assert [s.name for s in got] == [
        "loop.wait", STEP, "a", "feeder.read", "feeder.decode", "b",
        STEP, "a", "feeder.read", "feeder.decode", "b"]
    by_id = {s.id: s for s in got}
    main = threading.get_native_id()
    for s in got:
        parent = by_id.get(s.parent)
        if s.name.startswith("feeder."):
            # the other thread's stack: no parent from the main thread's
            assert s.thread in threads and s.thread != main
            assert (parent is None) == (s.name == "feeder.read")
            if parent is not None:
                assert parent.name == "feeder.read" and parent.thread == s.thread
        else:
            assert s.thread == main
            want = {"loop.wait": None, STEP: None, "a": STEP, "b": "a"}[s.name]
            assert (parent.name if parent else None) == want
        assert s.start <= s.end
    # a step's spans share its number; before the first step it is 0
    assert [s.step for s in got] == [0] + [1] * 5 + [2] * 5
    assert [s.id for s in got] == sorted(s.id for s in got)


def test_ring_keeps_its_bound_and_overwrites_the_oldest():
    rec = Spans(capacity=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    got = rec.records()
    assert [s.name for s in got] == [f"s{i}" for i in range(12, 20)]
    assert len(rec._ring) == 8
    assert [s.name for s in rec.records(after=16)] == ["s16", "s17", "s18",
                                                        "s19"]
    # a span still open is not read; it is once it closes
    with rec.span("open"):
        assert [s.name for s in rec.records(after=20)] == []
    assert [s.name for s in rec.records(after=20)] == ["open"]


def test_ranges_only_under_an_active_profiler(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = Spans(capacity=16)
    with rec.span("outer"):
        with rec.span("inner"):
            torch.ones(4).add_(1)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with rec.span("inner"):
                torch.ones(4).add_(1)
    assert entered == ["outer", "inner"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the ring's spans lie inside their ranges, on one offset of clocks
    spans = {s.name: s for s in rec.records()[-2:]}
    assert spans["inner"].end - spans["inner"].start <= inner["dur"] * 1e3


def _tiny(path_remat):
    cfg = tpretrain.tiny_train_config()
    if path_remat:
        cfg = tconfig.replace(cfg, path_remat=True, model=tconfig.replace(
            cfg.model, remat=False))
    return cfg


@pytest.mark.parametrize("path_remat", [False, True],
                         ids=["block_remat", "path_remat"])
def test_pretrain_step_records_its_spans_once_in_order(path_remat):
    """The step's spans of `train/step.py`, once each, nested as the step
    runs them; with one checkpoint region a path, the backward's rebuild
    of a path re-enters no forward span (from the engine's thread or
    any other)."""
    cfg = _tiny(path_remat)
    _, _, _, train = tpretrain.build_pretrain(cfg, device="cpu")
    batch = tpretrain.synthetic_batch(cfg, 4)
    mark = SPANS.last
    train(batch)
    got = SPANS.records(mark)
    assert [s.name for s in got] == STEP_SPANS
    ids = {s.name: s.id for s in got}
    parent = {s.name: next((n for n, i in ids.items() if i == s.parent), None)
              for s in got}
    assert parent[STEP] is None
    for name in STEP_SPANS[1:]:
        want = {"forward": "egovlpv2.step.forward",
                "optimizer": "egovlpv2.step.optimizer"}.get(
                    name.split(".")[1], STEP)
        assert parent[name] == want, name
    assert len({s.step for s in got}) == 1 and got[0].step == SPANS.step
    assert len({s.thread for s in got}) == 1


def _two_steps(profiled):
    cfg = tpretrain.tiny_train_config()
    model, _, _, train = tpretrain.build_pretrain(cfg, device="cpu")
    batches = [tpretrain.synthetic_batch(cfg, 4, np.random.default_rng(i))
               for i in range(2)]
    losses = []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            losses = [train(b) for b in batches]
    else:
        losses = [train(b) for b in batches]
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_spans_change_nothing_the_step_computes():
    """Two pretrain steps with the spans' ranges entered (a profiler on)
    and without: the same losses and parameters, bit for bit."""
    plain, plain_params = _two_steps(False)
    ranged, ranged_params = _two_steps(True)
    for a, b in zip(plain, ranged):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for n in plain_params:
        assert torch.equal(plain_params[n], ranged_params[n]), n


def test_span_means_since_the_last_read():
    rec = Spans(capacity=4)  # smaller than a log interval's spans
    means = SpanMeans({"a_ms": ("a",), "bx_ms": ("b", "x"), "c_ms": ("c",)},
                      spans=rec)
    assert means.read() == {}
    # "c" never ends a span: its group is left out, not read as 0
    want = {"a_ms": 0.0, "bx_ms": 0.0}
    for _ in range(3):
        for name in ("a", "b", "x", "other"):
            with rec.span(name):
                pass
        for s in rec.records()[-4:-1]:
            want["a_ms" if s.name == "a" else "bx_ms"] += (
                s.end - s.start) / 1e6 / 3
        means.add()
    assert means.read() == pytest.approx(want)
    with rec.span("a"):
        pass
    means.add()
    last = rec.records()[-1]
    assert means.read() == pytest.approx(
        {"a_ms": (last.end - last.start) / 1e6})


def test_cli_log_rows_carry_the_phase_means(tmp_path):
    save = tmp_path / "run"
    sets = ["model.remat=false", "global_batch_size=4", "max_text_len=12"]
    res = cli.main(["pretrain", "--synthetic", "--device", "cpu", "--epochs",
                    "1", "--steps_per_epoch", "4", "--log_every", "2",
                    "--save_dir", str(save), "--set", *sets,
                    "--config", _tiny_config_file(tmp_path)])
    assert [r["step"] for r in res["logged"]] == [2, 4]
    rows = [json.loads(line) for line in
            (save / "stats.txt").read_text().strip().splitlines()]
    assert [r["step"] for r in rows] == [2, 4]
    for row in rows:
        # the CPU has no synchronisation and no graph to replay: those
        # phases are left out, not read as 0
        assert set(cli.PHASE_SPANS) - set(row) == {"sync_ms", "replay_ms"}
        assert row["forward_ms"] > 0 and row["backward_ms"] > 0
        assert row["optimizer_ms"] > 0 and row["data_wait_ms"] > 0
        assert row["grad_sync_ms"] >= 0
        # a step's phases lie inside its time
        assert row["forward_ms"] + row["backward_ms"] + row[
            "optimizer_ms"] < 1e3 * max(res["step_seconds"]) * 2
    info = (save / "info.log").read_text()
    assert "'forward_ms':" in info and "'data_wait_ms':" in info


def _tiny_config_file(tmp_path):
    import dataclasses

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dataclasses.asdict(
        tpretrain.tiny_train_config())))
    return str(path)


def test_logging_keeps_no_exporter():
    """The port records its spans in the ring; the unread trace exporter
    is gone."""
    assert not hasattr(tlogging, "profile_trace")
    assert tlogging.span == SPANS.span and SPANS.capacity >= 16384
