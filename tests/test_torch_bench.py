"""The port's `bench` (`egovlpv2_torch/bench.py`, `cli bench`) against the
JAX package's root `bench.py` on the CPU: the same `TrainConfig` from the
same BENCH_* settings (bench.py's own statements, run on a given
environment), BENCH_ATTN other than "pallas" refused before a model is
built, the losses of `run_bench`'s steps against `build_pretrain` →
`init_state` → `step`, the calls bench.py makes, on one batch that no step
changes, the record's keys, types and rounding from a stubbed clock, and
two gloo ranks against one process on the global batch."""

import ast
import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_torch import bench as tbench
from egovlpv2_torch import cli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.parallel import mp_worker
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.weights import state_dict_from_flax
from tests.test_torch_parallel import ENV, REPO, TIMEOUT
from tests.test_torch_pretrain import BATCH, _configs, _inject_indices
from torch_parity import perturb

torch.set_num_threads(2)
BENCH_PY = os.path.join(REPO, "bench.py")
SETTINGS = ("BENCH_BATCH", "BENCH_REMAT", "BENCH_PATH_REMAT", "BENCH_ATTN")
FULL_BENCH_CONFIG = tbench.bench_config


@pytest.fixture(autouse=True)
def _no_bench_settings(monkeypatch):
    """Each test sets the BENCH_* variables it wants; none comes from the
    environment that runs the tests."""
    for name in SETTINGS:
        monkeypatch.delenv(name, raising=False)


def _bench_py_config(env: dict, n_dev: int):
    """The JAX `TrainConfig` of `bench.py::main`: its own statements for
    `batch_per_chip`, `batch_size` and `cfg`, run with `env` as os.environ
    on `n_dev` devices."""
    with open(BENCH_PY) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    wanted = [node for node in main.body if isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", None)
              in ("batch_per_chip", "batch_size", "cfg")]
    assert len(wanted) == 3
    names = {"os": types.SimpleNamespace(environ=env), "n_dev": n_dev,
             "TrainConfig": jconfig.TrainConfig,
             "ModelConfig": jconfig.ModelConfig,
             "OptimConfig": jconfig.OptimConfig}
    exec(compile(ast.Module(body=wanted, type_ignores=[]), BENCH_PY, "exec"),
         names)
    return names["cfg"]


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("env", [
    {}, {"BENCH_BATCH": "8"}, {"BENCH_BATCH": "32", "BENCH_REMAT": "1"},
    {"BENCH_REMAT": "0", "BENCH_PATH_REMAT": "1"},
    {"BENCH_REMAT": "1", "BENCH_PATH_REMAT": "1", "BENCH_ATTN": "pallas"},
    {"BENCH_BATCH": "1", "BENCH_PATH_REMAT": "0"}],
    ids=["defaults", "b8", "b32_remat", "path_remat", "both_remat_pallas",
         "b1"])
def test_bench_config_is_bench_py_s(env, world):
    got = tbench.bench_config(env, world)
    want = _bench_py_config(env, world)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.global_batch_size == int(env.get("BENCH_BATCH", 16)) * world


@pytest.mark.parametrize("attn", ["xla", "auto", ""])
def test_bench_attn_other_than_pallas_is_refused_before_a_model(
        monkeypatch, attn):
    def never(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(tbench, "build_pretrain", never)
    monkeypatch.setenv("BENCH_ATTN", attn)
    with pytest.raises(ValueError, match="never a plain version"):
        cli.main(["bench", "--device", "cpu"])
    if not torch.cuda.is_available():
        # the card, asked for and absent: no fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["bench"])


def _tiny_bench_config(env, world):
    """bench_config's settings (remat, path_remat, optimizer, global batch)
    on the tiny f32 pretrain config without dropout."""
    cfg, tiny = FULL_BENCH_CONFIG(env, world), _configs()[1]
    return tconfig.replace(
        tiny, model=tconfig.replace(tiny.model, remat=cfg.model.remat),
        optim=cfg.optim, path_remat=cfg.path_remat,
        global_batch_size=cfg.global_batch_size)


def test_run_bench_steps_match_the_jax_calls_of_bench_py(monkeypatch):
    """bench.py's calls on the tiny config (one device, no mesh):
    `synthetic_batch(cfg, B)`, `build_pretrain` → `init_state(batch)`, then
    `step(state, batch)` for 1 warm and 2 timed steps, from perturbed
    parameters that `run_bench`'s model takes through the weight bridge,
    dropout 0 and the mined pairs injected. Every step's loss_total within
    2e-4 (as the three optimizer steps of test_torch_pretrain), the
    reported loss the last step's; the steps move the loss (lr 1e-3 after
    a short warm-up); every step got the one batch, put once, unchanged
    after the run and equal to a fresh draw."""
    optim = dict(lr=1e-3, max_steps=6, warmup_frac=0.34, eps=1e-6)
    jcfg, tcfg = _configs(global_batch_size=BATCH)
    jcfg = jconfig.replace(jcfg, optim=jconfig.replace(jcfg.optim, **optim))
    tcfg = tconfig.replace(tcfg, optim=tconfig.replace(tcfg.optim, **optim))
    _inject_indices(monkeypatch)

    batch = jpretrain.synthetic_batch(jcfg, BATCH)
    _, init_state = jpretrain.build_pretrain(jcfg)
    state, jstep = init_state(batch)
    params = perturb(state.params, seed=11)
    state = state._replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    on_device = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        state, metrics = jstep(state, on_device)
        want.append(float(metrics["loss_total"]))

    seen = {"batches": [], "losses": []}

    def build(cfg, device):
        model, optimizer, scheduler, step = tpretrain.build_pretrain(
            cfg, device)
        model.load_state_dict(state_dict_from_flax(params), strict=True)

        def counted(b):
            if not seen["batches"]:
                seen["before"] = {k: v.clone() for k, v in b.items()}
            seen["batches"].append(b)
            metrics = step(b)
            seen["losses"].append(metrics["loss_total"].item())
            return metrics
        return model, optimizer, scheduler, counted

    monkeypatch.setattr(tbench, "build_pretrain", build)
    record = tbench.run_bench(tcfg, "cpu", warmup=1, iters=2)

    np.testing.assert_allclose(seen["losses"], want, rtol=2e-4, atol=2e-4)
    assert record["detail"]["loss"] == seen["losses"][-1]
    assert max(abs(a - b) for a, b in zip(want, want[1:])) > 1e-3
    assert record["detail"]["devices"] == 1
    assert record["detail"]["global_batch"] == BATCH
    first = seen["batches"][0]
    assert all(b is first for b in seen["batches"])
    fresh = tpretrain.synthetic_batch(tcfg, BATCH)
    assert set(first) == set(fresh) == set(batch)
    for key, value in first.items():
        assert torch.equal(value, seen["before"][key]), key
        np.testing.assert_array_equal(value.numpy(), fresh[key], err_msg=key)
        np.testing.assert_array_equal(fresh[key], batch[key], err_msg=key)


def test_cli_bench_prints_bench_py_s_record(monkeypatch, capsys):
    """`cli bench` prints one JSON line and nothing else, and returns it:
    bench.py's keys and types, `value`, `vs_baseline` and `step_ms` from the
    clock's window (a stub: 2.5 s for 10 steps of 2 clips), rounded as
    bench.py rounds them; the baseline is bench.py's expression."""
    monkeypatch.setattr(tbench, "bench_config", _tiny_bench_config)
    clock = iter([100.0, 102.5])
    monkeypatch.setattr(tbench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    monkeypatch.setenv("BENCH_BATCH", "2")
    record = cli.main(["bench", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [json.dumps(record)]
    assert list(record) == ["metric", "value", "unit", "vs_baseline",
                            "detail"]
    assert list(record["detail"]) == ["devices", "global_batch", "step_ms",
                                      "loss"]
    assert record["metric"] == "pretrain_clips_per_sec_per_chip"
    assert record["unit"] == "clips/s/chip"
    per_chip = 2 * 10 / 2.5 / 1
    assert record["value"] == round(per_chip, 3) == 8.0
    with open(BENCH_PY) as f:
        assert ("BASELINE_CLIPS_PER_SEC_PER_CHIP = 10_000_000 / (5 * 86400) "
                "/ 32") in f.read()
    assert tbench.BASELINE_CLIPS_PER_SEC_PER_CHIP == \
        10_000_000 / (5 * 86400) / 32
    assert record["vs_baseline"] == round(
        per_chip / (10_000_000 / (5 * 86400) / 32), 3) == 11.059
    detail = record["detail"]
    assert detail["devices"] == 1 and detail["global_batch"] == 2
    assert detail["step_ms"] == 250.0
    assert isinstance(record["value"], float)
    assert isinstance(record["vs_baseline"], float)
    assert type(detail["devices"]) is int
    assert type(detail["global_batch"]) is int
    assert isinstance(detail["step_ms"], float)
    assert isinstance(detail["loss"], float) and np.isfinite(detail["loss"])


# One process of `cli bench` on the tiny f32 config without dropout, its
# BENCH_BATCH the first argument; the rest are the command line.
_BENCH_CHILD = """
import os, sys
os.environ["BENCH_BATCH"] = sys.argv[1]
from egovlpv2_torch import bench, cli
from egovlpv2_torch.core.config import replace
from egovlpv2_torch.tasks.pretrain import tiny_train_config
full = bench.bench_config

def tiny(env, world):
    cfg, t = full(env, world), tiny_train_config()
    text = replace(t.model.text, hidden_dropout=0.0, attn_dropout=0.0)
    return replace(t, model=replace(t.model, text=text, remat=cfg.model.remat),
                   optim=cfg.optim, path_remat=cfg.path_remat,
                   global_batch_size=cfg.global_batch_size)

bench.bench_config = tiny
cli.main(sys.argv[2:])
"""


def _records(log: str) -> list:
    return [json.loads(line) for line in log.splitlines()
            if line.startswith('{"metric"')]


def test_two_gloo_ranks_equal_one_process_on_the_global_batch(tmp_path):
    """`cli bench --coordinator file://... --num_processes 2` with
    BENCH_BATCH=2 on each rank, and one process with BENCH_BATCH=4, all at
    once, each child under its time limit: rank 0 alone prints, over 2
    devices and a global batch of 4; the last loss equals the one
    process's within 1e-5 (the file's tolerance in
    test_torch_parallel.py)."""
    child = [sys.executable, "-c", _BENCH_CHILD]
    commands = [child + ["2", "bench", "--device", "cpu", "--coordinator",
                         f"file://{tmp_path}/rdzv", "--num_processes", "2",
                         "--process_id", str(i)] for i in range(2)]
    commands.append(child + ["4", "bench", "--device", "cpu"])
    codes, logs = mp_worker.run_ranks(commands, TIMEOUT, env=ENV, cwd=REPO)
    assert codes == [0] * 3, "\n---\n".join(logs)
    assert "# multihost: process 0/2" in logs[0]
    two, silent, one = (_records(log) for log in logs)
    assert len(two) == 1 and silent == [] and len(one) == 1, logs
    two, one = two[0]["detail"], one[0]["detail"]
    assert (two["devices"], two["global_batch"]) == (2, 4)
    assert (one["devices"], one["global_batch"]) == (1, 4)
    assert np.isfinite(two["loss"])
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=0, atol=1e-5)
