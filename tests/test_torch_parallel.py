"""Data parallel of the port over real processes on the CPU (gloo, two
ranks, a `file://` rendezvous under the test's directory, every child
under its own time limit): the collectives' adjoints, two ranks against
one process on the same global batch (pretrain, and the dual fine-tunes
with NormSoftmax and AdaptiveMaxMargin), two ranks against the JAX
package's one-process step, per-rank dropout with shared ITM mining, the
collective checkpoint, the multi-host flags of `egovlpv2_torch.cli` (the
counterpart of `tests/test_multiprocess.py`'s CLI tests), resume, SIGTERM
to one rank, and two ranks on one device refused."""

import concurrent.futures
import dataclasses
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.objectives.itm_mining import ITMIndices as JITMIndices
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_tpu.train import optimizer as jopt
from egovlpv2_tpu.train import step as jstep
from egovlpv2_torch import cli
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.parallel import distributed, mesh, mp_worker
from egovlpv2_torch.train import checkpoint
from egovlpv2_torch.train.checkpoint import CheckpointManager
from egovlpv2_torch.weights import (flax_from_state_dict,
                                    state_dict_from_flax, training_init_)
from tests.test_cli import TINY
from torch_parity import perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds a child may take; the runs take 5-20 s
ENV = {**os.environ, "HF_HUB_OFFLINE": "1", "OMP_NUM_THREADS": "2",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
# the tiny CLI config without dropout: two ranks equal one process
NO_DROPOUT = ["model.text.hidden_dropout=0", "model.text.attn_dropout=0"]


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _metric(results, key):
    return np.array([[m[key] for m in r["metrics"]] for r in results])


# ---------------- the collectives ----------------

_COLLECTIVES_CHILD = """
import json, sys
import torch
import torch.distributed as dist
from egovlpv2_torch.parallel import collectives, distributed

rank, rdzv, refuse_rdzv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
# two ranks that post one device are refused, on both, before any group
store, r, w = next(dist.rendezvous(refuse_rdzv, rank=rank, world_size=2))
try:
    distributed.refuse_shared_devices(store, r, w, "GPU-one-card")
    refused = ""
except RuntimeError as e:
    refused = str(e)
distributed.refuse_shared_devices(dist.PrefixStore("again", store), r, w,
                                  f"GPU-card-{rank}")  # two cards pass
topo = distributed.initialize_multihost(rdzv, 2, rank, device="cpu")
gen = torch.Generator().manual_seed(7)
x_all = torch.randn(4, 3, generator=gen)          # rank r holds rows 2r:2r+2
cots = torch.randn(2, 8, 3, generator=gen)        # rank r's cotangent
s_all = torch.randn(2, 5, generator=gen)
x = x_all[2 * rank:2 * rank + 2].clone().requires_grad_()
y = collectives.all_gather(x)
(y * cots[rank, :4]).sum().backward()
s = s_all[rank].clone().requires_grad_()
t = collectives.all_reduce_sum(s)
(t * cots[rank, 0, :1].expand(5) * torch.arange(5.0)).sum().backward()
ints = collectives.all_gather(torch.tensor([rank, 10 + rank]))
anyr = [collectives.any_rank(rank == 1), collectives.any_rank(False)]
objs = collectives.all_gather_object({"rank": rank})
distributed.barrier("done")
distributed.shutdown()
json.dump({"topo": {k: str(v) for k, v in topo.items()}, "y": y.tolist(),
           "x_grad": x.grad.tolist(), "t": t.tolist(),
           "s_grad": s.grad.tolist(), "ints": ints.tolist(), "any": anyr,
           "objs": objs, "refused": refused}, open(out, "w"))
"""


@pytest.fixture(scope="module")
def collectives_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    outs = [str(d / f"out_{r}.json") for r in range(2)]
    codes, logs = mp_worker.run_ranks(
        [[sys.executable, "-c", _COLLECTIVES_CHILD, str(r),
          f"file://{d}/rdzv", f"file://{d}/refuse", outs[r]]
         for r in range(2)], TIMEOUT, env=ENV, cwd=REPO)
    assert codes == [0, 0], "\n---\n".join(logs)
    return [json.load(open(o)) for o in outs]


def test_all_gather_and_all_reduce_have_the_sum_adjoint(collectives_run):
    """Forward: every rank holds the ranks' rows in rank order (ints too),
    and the sum. Backward, each rank with its own cotangent: a rank's rows
    get the sum of every rank's cotangent on them, as one process's
    autograd gives on the concatenated input under the sum of the ranks'
    losses."""
    gen = torch.Generator().manual_seed(7)
    x_all = torch.randn(4, 3, generator=gen).requires_grad_()
    cots = torch.randn(2, 8, 3, generator=gen)
    s_all = torch.randn(2, 5, generator=gen).requires_grad_()
    loss = sum((x_all * cots[r, :4]).sum() for r in range(2))
    total = s_all.sum(0)
    loss = loss + sum((total * cots[r, 0, :1].expand(5) * torch.arange(5.0)
                       ).sum() for r in range(2))
    loss.backward()
    for r, res in enumerate(collectives_run):
        assert res["topo"]["process_index"] == str(r)
        assert res["topo"]["process_count"] == "2"
        assert res["topo"]["device"] == "cpu"
        assert res["topo"]["backend"] == "gloo"
        _close(res["y"], x_all.detach().numpy(), 0, 0, "gathered rows")
        _close(res["x_grad"], x_all.grad[2 * r:2 * r + 2].numpy(), 1e-6,
               1e-6, "gather adjoint")
        _close(res["t"], total.detach().numpy(), 1e-6, 1e-6, "sum")
        _close(res["s_grad"], s_all.grad[r].numpy(), 1e-6, 1e-6,
               "sum adjoint")
        assert res["ints"] == [0, 10, 1, 11]
        assert res["any"] == [True, False]
        assert res["objs"] == [{"rank": 0}, {"rank": 1}]


def test_two_ranks_on_one_device_are_refused(collectives_run, monkeypatch):
    """Both ranks raise the same clear error from the rendezvous store,
    before any collective, when they post one device; the CPU is never
    shared. Without CUDA, a CUDA group is refused before it starts."""
    for res in collectives_run:
        assert res["refused"].startswith("two ranks on one device: ranks "
                                         "[0, 1] on GPU-one-card")
        assert "LOCAL_RANK" in res["refused"]
    assert distributed.shared_devices(["GPU-a", "GPU-b", "GPU-a", None,
                                       None]) == {"GPU-a": [0, 2]}
    assert distributed.shared_devices([None, None]) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize_multihost("localhost:1", 2, 0,
                                             device="cuda")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize_multihost(device="cpu")
    with pytest.raises(ValueError, match="--num_processes"):
        distributed.initialize_multihost("localhost:1", device="cpu")


def test_initialize_multihost_defaults_to_the_card():
    """The public entry point runs on the card unless its caller asks for
    the CPU: without CUDA its default raises before any rendezvous."""
    default = inspect.signature(
        distributed.initialize_multihost).parameters["device"].default
    assert default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize_multihost("localhost:1", 2, 0)


def test_local_rows_and_batch_size(monkeypatch):
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    assert mesh.local_rows(batch, 8) is batch  # one process: the batch
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    monkeypatch.setattr(mesh, "rank", lambda: 2)
    rows = mesh.local_rows(batch, 8)
    np.testing.assert_array_equal(rows["a"], [4, 5])
    np.testing.assert_array_equal(rows["b"], [[8, 9], [10, 11]])
    assert mesh.local_batch_size(8) == 2
    with pytest.raises(ValueError, match="not divisible"):
        mesh.local_batch_size(6)


def test_a_checkpoint_resumes_on_as_many_ranks_as_saved_it(monkeypatch):
    with pytest.raises(ValueError, match="saved by 2 processes"):
        checkpoint.load_train_state_({"rank_generators": [None, None]},
                                     *[None] * 4)
    monkeypatch.setattr(checkpoint, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="saved by 1 processes"):
        checkpoint.load_train_state_({"generator": None}, *[None] * 4)


# ---------------- two ranks against one process ----------------


def _perturbed_state(task, path):
    """The seeded training init of the worker's model with seeded noise on
    every parameter: the zero-initialised time attention and gates then
    get real gradients, where Adam would turn a gradient that is zero but
    for rounding into a step of +-lr (`tests/test_torch_pretrain.py` starts
    from perturbed parameters for the same reason)."""
    cfg = mp_worker._config(task, dropout=False)
    model = training_init_(EgoVLPv2(cfg.model),
                           torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator().manual_seed(11)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
             for k, v in model.state_dict().items()}
    torch.save(state, path)
    return str(path)


def _one_and_two(d, task, **flags):
    """The worker's run in this process (no group) and, meanwhile, on two
    ranks, from one perturbed state; the final parameters in d/one.pt and
    d/two.pt."""
    state = _perturbed_state(task, d / "init.pt")
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        mp_worker.launch_workers, 2, str(d / "two"), TIMEOUT, task=task,
        steps=3, state=state, params_out=str(d / "two.pt"), **flags)
    one = [mp_worker.run(mp_worker.parse_args([
        "--task", task, "--steps", "3", "--state", state, "--params_out",
        str(d / "one.pt")]))]
    return one, ranks.result()


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """The pretrain worker on one process and on two ranks, which also save
    and restore collectively."""
    d = tmp_path_factory.mktemp("pretrain")
    one, two = _one_and_two(d, "pretrain", ckpt_dir=str(d / "two" / "ckpt"))
    return one, two, d


def _hold_to_one_process(one, two, d):
    """Both ranks report the same metrics, bit for bit, and hold the same
    parameters; those equal one process's: the losses within 1e-5, the
    global gradient's norm within 1e-5 of itself, the parameters after
    three AdamW steps within 2e-4 of max(1, max |param|) of each tensor."""
    assert [r["nproc"] for r in two] == [2, 2] and one[0]["nproc"] == 1
    assert two[0]["metrics"] == two[1]["metrics"]
    assert two[0]["params_digest"] == two[1]["params_digest"]
    for key in two[0]["metrics"][0]:
        rtol = 1e-5 if key == "grad_norm" else 0
        atol = 0 if key == "grad_norm" else 1e-5
        _close(_metric(two, key)[0], _metric(one, key)[0], rtol, atol, key)
    a = torch.load(d / "one.pt", weights_only=True)
    b = torch.load(d / "two.pt", weights_only=True)
    for name, p in a.items():
        scale = max(1.0, p.abs().max().item())
        _close(b[name].numpy(), p.numpy(), 0, 2e-4 * scale, name)


def test_pretrain_two_ranks_equal_one_process(pretrain_runs):
    one, two, d = pretrain_runs
    _hold_to_one_process(one, two, d)
    # the ranks mined the same pairs, those one process mined
    assert two[0]["mined"] == two[1]["mined"] == one[0]["mined"]
    assert set(two[0]["metrics"][0]) == {"loss_egonce", "loss_mlm",
                                         "loss_itm", "loss_total",
                                         "grad_norm"}


def test_collective_checkpoint_round_trip(pretrain_runs):
    """train_state gathers each rank's dropout generator to rank 0, which
    saves; a new trainer on each rank restores its parameters and its own
    generator, and the shared mining generator, exactly."""
    _, two, d = pretrain_runs
    assert all(r["ckpt_roundtrip"] for r in two)
    state = CheckpointManager(str(d / "two" / "ckpt")).restore(3)
    assert len(state["rank_generators"]) == 2
    assert not torch.equal(state["rank_generators"][0],
                           state["rank_generators"][1])
    assert state["mining_generator"] is not None


@pytest.mark.parametrize("task", ["charades", "epic"])
def test_dual_fine_tune_two_ranks_equal_one_process(tmp_path, task):
    """NormSoftmax (Charades-Ego) and AdaptiveMaxMargin with per-row
    relevancy (EK-100) over the gathered towers and weights."""
    one, two = _one_and_two(tmp_path, task)
    _hold_to_one_process(one, two, tmp_path)
    assert two[0]["mined"] == []


def test_dropout_differs_by_rank_while_mining_agrees(tmp_path):
    """With dropout on, the ranks draw different masks (their dropout
    generators are seeded by rank) and mine the same pairs (one generator
    of one seed on every rank)."""
    two = mp_worker.launch_workers(2, str(tmp_path), TIMEOUT, steps=2,
                                   dropout=True)
    a, b = (r["dropout_mask"] for r in two)
    assert a is not None and len(a) == len(b)
    assert a != b and 0 < sum(a) < len(a)
    assert two[0]["mined"] == two[1]["mined"] and len(two[0]["mined"]) == 2
    assert two[0]["generator"] != two[1]["generator"]
    assert two[0]["metrics"] == two[1]["metrics"]


# ---------------- two ranks against the JAX package ----------------

# the inputs of `tests/test_torch_pretrain.py::test_three_optimizer_steps_
# match_jax`, where one process is held to the JAX step: its batch, its
# batches' seeds, its perturbation and its mined pairs
BATCH = 6
BATCH_SEED = 10
VIDEO_IDX = np.array([0, 3, 2, 5, 4, 1])
TEXT_IDX = np.array([0, 1, 2, 3, 0, 5])
LABELS = np.array([1, 0, 1, 0, 0, 0])


def _jax_config():
    """The JAX package's config of the worker's tiny pretrain (dropout
    rates 0, no rematerialisation, XLA attention: what the port's config
    computes)."""
    tcfg = mp_worker._config("pretrain", dropout=False)
    jcfg = jpretrain.tiny_train_config()
    jm = jcfg.model
    jcfg = jconfig.replace(
        jcfg, log_grad_norm=True, path_remat=False,
        model=jconfig.replace(
            jm, remat=False, attn_impl="xla",
            text=jconfig.replace(jm.text, hidden_dropout=0.0,
                                 attn_dropout=0.0),
            video=jconfig.replace(jm.video, drop_rate=0.0,
                                  drop_path_rate=0.0)),
        optim=jconfig.replace(jcfg.optim, lr=1e-3, max_steps=6,
                              warmup_frac=0.34, eps=1e-6))
    same = dataclasses.asdict(jcfg)
    same["model"].update(remat=True, attn_impl="auto")
    same["path_remat"] = True
    assert same == dataclasses.asdict(tcfg)
    return tcfg, jcfg


def _jax_steps(monkeypatch, jcfg, params, batches, mined):
    """`egovlpv2_tpu`'s one-process `make_train_step` from flax `params`
    over `batches`, step i mining the pairs `mined[i]`; returns the state
    and each step's metrics. The pairs are arguments of the jitted step,
    which a step's constants, kept from its trace, could not be."""
    jmodel = JaxEgoVLPv2(jcfg.model)
    traced = {}
    monkeypatch.setattr(jstep, "mine_itm_indices",
                        lambda *a, **k: traced["pairs"])
    tx = jopt.make_optimizer(jcfg.optim, params)
    step_fn = jstep.make_train_step(jmodel, jcfg, tx).__wrapped__

    @jax.jit
    def jtrain(state, batch, pairs):
        traced["pairs"] = JITMIndices(*pairs)
        return step_fn(state, batch)

    state = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                             tx.init(params), jnp.zeros((), jnp.int32),
                             jax.random.PRNGKey(4))
    refs = []
    for batch, pairs in zip(batches, mined):
        state, ref = jtrain(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                            tuple(jnp.asarray(np.asarray(x)) for x in pairs))
        refs.append(ref)
    return state, refs


def _hold_metrics_to_jax(two, refs):
    """Both ranks' loss parts and gradient norm within 2e-4 of JAX's."""
    for i, ref in enumerate(refs):
        for r in two:
            assert set(r["metrics"][i]) == set(ref)
            for key, value in r["metrics"][i].items():
                _close(value, float(ref[key]), 2e-4, 2e-4, f"{key} step {i}")


def _hold_params_to_jax(got, state):
    """Every parameter within 2e-4 of JAX's, times max(1, max |param|) of
    its tensor, and 2e-4 of its own size."""
    ref = state_dict_from_flax(state.params)
    assert set(got) == set(ref)
    for name, p in ref.items():
        scale = max(1.0, p.abs().max().item())
        _close(got[name].numpy(), p.numpy(), 2e-4, 2e-4 * scale, name)


def test_pretrain_two_ranks_match_the_jax_step(tmp_path, monkeypatch):
    """Two ranks, from the worker's seeded init perturbed as flax
    parameters and brought back through the weight bridge, against
    `egovlpv2_tpu`'s one-process step on the same global batches and mined
    pairs, on `tests/test_torch_pretrain.py`'s inputs: the loss parts and
    the gradient's norm within 2e-4, the parameters after three AdamW
    steps within 2e-4 of max(1, max |param|) of each tensor, that test's
    tolerances."""
    tcfg, jcfg = _jax_config()
    batches = [mp_worker.global_batch(tcfg, "pretrain", BATCH, i, BATCH_SEED)
               for i in range(3)]
    start = training_init_(EgoVLPv2(tcfg.model),
                           torch.Generator().manual_seed(tcfg.seed))
    params = perturb(flax_from_state_dict(start.state_dict()), seed=3)
    init = str(tmp_path / "init.pt")
    torch.save(state_dict_from_flax(params), init)
    np.savez(tmp_path / "idx.npz", video_idx=VIDEO_IDX, text_idx=TEXT_IDX,
             labels=LABELS)
    # the two ranks run while JAX compiles its step
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        mp_worker.launch_workers, 2, str(tmp_path / "two"), TIMEOUT, steps=3,
        global_batch=BATCH, batch_seed=BATCH_SEED,
        state=init, itm_indices=str(tmp_path / "idx.npz"),
        params_out=str(tmp_path / "two.pt"))
    state, refs = _jax_steps(monkeypatch, jcfg, params, batches,
                             [(VIDEO_IDX, TEXT_IDX, LABELS)] * 3)
    _hold_metrics_to_jax(ranks.result(), refs)
    _hold_params_to_jax(torch.load(tmp_path / "two.pt", weights_only=True),
                        state)


def test_pretrain_two_ranks_match_the_jax_step_on_the_worker_batch(
        pretrain_runs, monkeypatch):
    """The two-rank run that equals one process (the worker's global batch
    of 8, its perturbed start, the pairs its ranks mined) against the JAX
    step from the same parameters, the same batches and those pairs, at
    `tests/test_torch_pretrain.py`'s tolerances: the loss parts and the
    gradient's norm within 2e-4, the parameters after three AdamW steps
    within 2e-4 of max(1, max |param|) of each tensor."""
    _, two, d = pretrain_runs
    tcfg, jcfg = _jax_config()
    batches = [mp_worker.global_batch(tcfg, "pretrain", 8, i)
               for i in range(3)]
    params = flax_from_state_dict(torch.load(d / "init.pt",
                                             weights_only=True))
    state, refs = _jax_steps(monkeypatch, jcfg, params, batches,
                             two[0]["mined"])
    _hold_metrics_to_jax(two, refs)
    _hold_params_to_jax(torch.load(d / "two.pt", weights_only=True), state)


# ---------------- the command line over two processes ----------------


def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{"epoch"') and '"step"' in line]


def _losses(rows):
    return [{k: v for k, v in r.items() if k != "step_ms"} for r in rows]


def _cli_ranks_and_one(tmp_path, argv, ranks_argv):
    """`python -m egovlpv2_torch.cli <argv> <ranks_argv> --coordinator
    file://... --num_processes 2 --process_id i` on each of two ranks and,
    at the same time, `<argv>` in one process without a group; returns
    the three outputs."""
    cli_command = [sys.executable, "-m", "egovlpv2_torch.cli", *argv]
    commands = [cli_command + ranks_argv + [
        "--coordinator", f"file://{tmp_path}/rdzv", "--num_processes", "2",
        "--process_id", str(i)] for i in range(2)] + [cli_command]
    codes, logs = mp_worker.run_ranks(commands, TIMEOUT, env=ENV, cwd=REPO)
    assert codes == [0] * 3, "\n---\n".join(logs)
    return logs


@pytest.fixture()
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.mark.parametrize("command", ["pretrain", "ft-charades"])
def test_cli_two_processes_equal_one(tiny_config, tmp_path, command):
    """The port's CLI under two real processes, a shared save_dir: both
    `# multihost` lines, the same losses on each rank, those of one
    process on the same global batch (within 1e-5), stats.txt, info.log
    and config.json from rank 0 alone, and ckpt/."""
    save = tmp_path / "run"
    common = [command, "--synthetic", "--device", "cpu", "--config",
              tiny_config, "--steps_per_epoch", "2", "--epochs", "1",
              "--set", *NO_DROPOUT, "global_batch_size=4"]
    logs = _cli_ranks_and_one(tmp_path, common, ["--save_dir", str(save)])
    assert "# multihost: process 0/2, 1 local / 2 global devices (cpu, " \
        "gloo)" in logs[0]
    assert "# multihost: process 1/2" in logs[1]
    assert "# multihost" not in logs[2]
    rows = [_losses(_rows(log)) for log in logs]
    assert len(rows[0]) == 2 and rows[0] == rows[1], rows
    assert len(rows[2]) == 2
    for got, want in zip(rows[0], rows[2]):
        assert got.keys() == want.keys() and got["step"] == want["step"]
        for key in got:
            _close(got[key], want[key], 0, 1e-5, key)
    stats = (save / "stats.txt").read_text().strip().splitlines()
    assert [json.loads(line)["step"] for line in stats] == [1, 2]
    info = (save / "info.log").read_text()
    assert info.count("step 1:") == 1 and info.count("done at step 2") == 1
    assert (save / "config.json").exists()
    assert CheckpointManager(str(save / "ckpt")).latest_step() == 2


_RESUME_CHILD = """
import json, sys
from egovlpv2_torch import cli
rank, root, config = sys.argv[1], sys.argv[2], sys.argv[3]
common = ["pretrain", "--config", config, "--synthetic", "--device", "cpu",
          "--steps_per_epoch", "2", "--set", "global_batch_size=4",
          "--num_processes", "2", "--process_id", rank]
out = {}
for name, extra in (("whole", ["--epochs", "2", "--save_dir", root + "/whole"]),
                    ("cut", ["--epochs", "1", "--save_dir", root + "/cut",
                             "--init_val"]),
                    ("resumed", ["--epochs", "2", "--save_dir", root + "/cut",
                                 "--resume"])):
    res = cli.main(common + extra + ["--coordinator",
                                     "file://" + root + "/rdzv_" + name])
    out[name] = [{k: v for k, v in r.items() if k != "step_ms"}
                 for r in res["logged"]]
json.dump(out, open(root + "/resume_" + rank + ".json", "w"))
"""


def test_cli_two_process_resume_equals_the_run_that_did_not_stop(
        tiny_config, tmp_path):
    """Two ranks with dropout on: two epochs in one run, against one epoch,
    saved, and a second run that resumes for the second: steps 3-4 and the
    saved state at step 4 (parameters, AdamW, each rank's dropout
    generator) are the same bits."""
    codes, logs = mp_worker.run_ranks(
        [[sys.executable, "-c", _RESUME_CHILD, str(r), str(tmp_path),
          tiny_config] for r in range(2)], TIMEOUT, env=ENV, cwd=REPO)
    assert codes == [0, 0], "\n---\n".join(logs)
    runs = [json.load(open(tmp_path / f"resume_{r}.json")) for r in range(2)]
    assert runs[0] == runs[1]
    whole, resumed = runs[0]["whole"], runs[0]["resumed"]
    assert [r["step"] for r in resumed] == [3, 4]
    assert resumed == whole[2:]
    states = [CheckpointManager(str(tmp_path / d / "ckpt")).restore(4)
              for d in ("whole", "cut")]
    assert len(states[0]["rank_generators"]) == 2
    for key in ("model", "rank_generators"):
        a, b = states[0][key], states[1][key]
        items = a.items() if isinstance(a, dict) else enumerate(a)
        for k, v in items:
            assert torch.equal(v, b[k]), (key, k)
    assert states[0]["optimizer"]["state"].keys() == \
        states[1]["optimizer"]["state"].keys()
    for k, v in states[0]["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(t, states[1]["optimizer"]["state"][k][name])


def test_sigterm_to_one_rank_stops_both_at_one_saved_step(tiny_config,
                                                          tmp_path):
    """SIGTERM to rank 1 alone after its first step: the ranks agree on it
    after the step in flight, rank 0 saves at that step, and both exit 0
    with the same last step."""
    save = tmp_path / "run"
    commands = [[sys.executable, "-m", "egovlpv2_torch.cli", "pretrain",
                 "--synthetic", "--device", "cpu", "--config", tiny_config,
                 "--steps_per_epoch", "500", "--set", "global_batch_size=4",
                 "--save_dir", str(save), "--coordinator",
                 f"file://{tmp_path}/rdzv", "--num_processes", "2",
                 "--process_id", str(i)] for i in range(2)]
    procs = [subprocess.Popen(cmd, env=ENV, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    logs = [[], []]

    def read(i):
        for line in procs[i].stdout:
            logs[i].append(line)
            if i == 1 and line.startswith('{"epoch": 0, "step": 1,'):
                procs[1].send_signal(signal.SIGTERM)

    readers = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(2)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while any(p.poll() is None for p in procs) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for t in readers:
        t.join()
    text = ["".join(log) for log in logs]
    assert [p.returncode for p in procs] == [0, 0], "\n---\n".join(text)
    last = [_rows(t)[-1]["step"] for t in text]
    assert last[0] == last[1] < 500, last
    assert f"preempted (SIGTERM): saved at step {last[0]}, exiting" in text[0]
    manager = CheckpointManager(str(save / "ckpt"))
    assert manager.latest_step() == last[0]
    assert manager.last_epoch() == -1  # the unfinished epoch is replayed
    assert len(manager.restore()["rank_generators"]) == 2


def test_other_commands_run_on_rank_zero(tmp_path, capsys):
    """A command with no data-parallel form runs on rank 0 alone and writes
    from there; another rank returns at once. One process of a group of
    one here: the command runs and the group is ended after it."""
    moments = tmp_path / "m.json"
    moments.write_text(json.dumps({"videos": []}))
    info = tmp_path / "info.json"
    info.write_text(json.dumps({"videos": []}))
    out = tmp_path / "anno.json"
    argv = ["mq-anno", "--moments", str(moments), "--info", str(info),
            "--out", str(out), "--coordinator", f"file://{tmp_path}/rdzv",
            "--num_processes", "1", "--process_id", "0"]
    assert cli.main(argv) == {}
    assert out.exists() and not torch.distributed.is_initialized()
    assert "# multihost: process 0/1" in capsys.readouterr().out
