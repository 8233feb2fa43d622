"""The port's copies of the JAX package's training-loop helpers against the
originals on the same inputs: the CLI's `Monitor` and
`_save_resolved_config`, `utils/logging.py` (`StatsWriter`, `Throughput`,
`setup_logging`), `utils/visualizer.py` and the
single-process part of `parallel/distributed.py` (`PreemptionGuard`,
`is_main_process`, `barrier`)."""

import os
import signal
import time

import numpy as np
import pytest

from egovlpv2_tpu import cli as jcli
from egovlpv2_tpu.parallel import distributed as jdist
from egovlpv2_tpu.utils import logging as jlogging
from egovlpv2_tpu.utils import visualizer as jvisualizer
from egovlpv2_torch import cli as tcli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.parallel import distributed as tdist
from egovlpv2_torch.train.checkpoint import CheckpointManager
from egovlpv2_torch.utils import logging as tlogging
from egovlpv2_torch.utils import visualizer as tvisualizer

KEYS = ("vtc/Inter-video", "loss_total")


def _metric_sequence(seed: int, n: int = 12):
    """Epoch metrics drawn from a seed: values that repeat (ties), and now
    and then the monitored key missing."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = {k: float(rs.choice([0.0, 25.0, 33.3, 50.0, rs.rand()]))
             for k in KEYS}
        if rs.rand() < 0.2:
            del m[KEYS[rs.randint(2)]]
        out.append(m)
    return out


@pytest.mark.parametrize("early_stop", [0, 1, 2, 3])
@pytest.mark.parametrize("spec", ["max:vtc/Inter-video", "min:loss_total"])
def test_monitor_matches_jax(spec, early_stop):
    ref, got = jcli.Monitor(spec, early_stop), tcli.Monitor(spec, early_stop)
    for seed in range(3):
        for m in _metric_sequence(seed):
            assert got.update(m) == ref.update(m)
            assert got.should_stop == ref.should_stop
            assert got.state_dict() == ref.state_dict()
    other = jcli.Monitor("max:other").state_dict()
    assert tcli.Monitor(spec).load_state_dict(other) is False
    for bad in ("vtc/Inter-video", "best:x", "max:"):
        with pytest.raises(ValueError, match="monitor spec"):
            tcli.Monitor(bad)


def test_monitor_state_roundtrip(tmp_path):
    """The monitor's best value and stale count survive a resume through
    the checkpoint directory (`tests/test_misc_utils.py:80`, on the
    port)."""
    m = tcli.Monitor("max:acc", early_stop=3)
    assert m.update({"acc": 0.5})
    assert not m.update({"acc": 0.4})
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_monitor(m.state_dict())
    m2 = tcli.Monitor("max:acc", early_stop=3)
    assert m2.load_state_dict(ckpt.monitor_state())
    assert m2.best == 0.5 and m2.not_improved == 1
    # a run that monitors another metric ignores the saved state
    assert not tcli.Monitor("min:loss").load_state_dict(ckpt.monitor_state())
    ckpt.close()


@pytest.mark.parametrize("config, sets", [
    (None, []),
    ("configs/ft_charades.json", ["global_batch_size=8",
                                  "optim.betas=[0.9, 0.95]"]),
    ("configs/eval_egomcq.json", ["model.video.num_frames=4"]),
], ids=["defaults", "ft_charades_set", "eval_egomcq_set"])
def test_save_resolved_config_matches_jax(tmp_path, config, sets):
    tcli._save_resolved_config(tconfig.load_train_config(config, sets),
                               str(tmp_path / "torch"))
    jcli._save_resolved_config(jcli.load_train_config(config, sets),
                               str(tmp_path / "jax"))
    got = (tmp_path / "torch" / "config.json").read_bytes()
    assert got == (tmp_path / "jax" / "config.json").read_bytes()
    tcli._save_resolved_config(tconfig.load_train_config(), None)  # no-op


def _page_inputs(seed: int):
    rs = np.random.RandomState(seed)
    queries = [f"query <{i}> & more" for i in range(7)]
    sims = rs.randn(7, 9).astype(np.float32)
    return queries, sims


@pytest.mark.parametrize("gt", ["diagonal", "permuted"])
def test_retrieval_visualizer_matches_jax(tmp_path, gt):
    pages = {}
    for name, module in (("jax", jvisualizer), ("torch", tvisualizer)):
        viz = module.RetrievalVisualizer(str(tmp_path / name / "web"))
        for epoch in range(2):
            queries, sims = _page_inputs(epoch)
            gt_indices = (list(range(7)) if gt == "diagonal" else
                          np.random.RandomState(epoch).permutation(9)[:7])
            viz.write_epoch(epoch, queries, sims, gt_indices=gt_indices)
        root = tmp_path / name / "web"
        pages[name] = {p: (root / p).read_bytes()
                       for p in sorted(os.listdir(root))}
    assert list(pages["torch"]) == ["index.html", "retrieval_epoch0.html",
                                    "retrieval_epoch1.html"]
    assert pages["torch"] == pages["jax"]
    assert b'class="miss"' in pages["torch"]["retrieval_epoch0.html"]


def test_stats_writer_and_throughput_match_jax(tmp_path, monkeypatch):
    rows = [(1, {"loss_total": np.float32(2.5), "lr": 1e-4}),
            (2, {"val_vtc/Inter-video": 33.3333})]
    for name, module in (("jax", jlogging), ("torch", tlogging)):
        writer = module.StatsWriter(str(tmp_path / name))
        for step, metrics in rows:
            writer.write(step, metrics)
        writer.close()
    assert (tmp_path / "torch" / "stats.txt").read_bytes() == \
        (tmp_path / "jax" / "stats.txt").read_bytes()

    ticks = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.25] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    ref, got = jlogging.Throughput(8, window=3), tlogging.Throughput(8,
                                                                     window=3)
    ref_rates = [ref.tick() for _ in range(6)]
    assert [got.tick() for _ in range(6)] == ref_rates
    assert ref_rates[0] == {} and ref_rates[-1]["items_per_sec"] == 8 / (
        (3.25 - 1.25) / 3)


def test_setup_logging(tmp_path):
    log = tlogging.setup_logging(str(tmp_path / "run"))
    log.info("step %d: %s", 3, {"loss": 1.0})
    assert log.name == "egovlpv2_torch"
    assert "step 3: {'loss': 1.0}" in (tmp_path / "run" / "info.log").read_text()
    tlogging.setup_logging(None)  # closes the file handler


def test_preemption_guard_sets_flag_and_runs_callback():
    """`tests/test_preemption.py:16` on the port's guard."""
    before = signal.getsignal(signal.SIGTERM)
    fired = []
    guard = tdist.PreemptionGuard(on_preempt=lambda: fired.append(1))
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if guard.preempted:
                break
            time.sleep(0.01)
        assert guard.preempted and fired == [1]
        # a second SIGTERM does not run the callback again
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert fired == [1]
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) == before
    guard.restore()  # twice is harmless
    assert signal.getsignal(signal.SIGTERM) == before


def test_one_process_is_the_main_one_and_meets_itself():
    assert tdist.is_main_process() is True
    assert jdist.is_main_process() is True
    tdist.barrier("alone")  # returns at once
