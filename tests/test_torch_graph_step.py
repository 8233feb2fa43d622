"""The training step replayed as one CUDA graph (`train/step.py::
GraphStep`): which steps capture (the CPU tests), and on the card that a
replayed step is the eager step bit for bit over a warming learning rate,
that held metrics keep their step's values, that a batch of other shapes
runs eager in between and the shapes are captured again, that the dual and TaskQA steps capture too, that
every hand-written kernel runs inside the replay, and that dropping the
step, or a batch of other shapes, returns its memory pool. The card tests
skip without a CUDA device."""

import gc
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.downstream import taskqa as tqa
from egovlpv2_torch.objectives.itm_mining import (categorical,
                                                   mine_itm_indices)
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.tasks import pretrain as tpretrain
from egovlpv2_torch.tasks import retrieval as tretrieval
from egovlpv2_torch.train import optimizer as topt
from egovlpv2_torch.train import step as tstep
from egovlpv2_torch.train.checkpoint import load_train_state_, train_state
from egovlpv2_torch.utils.logging import CAPTURE, REPLAY, SPANS, STEP

CSRC = Path(tstep.__file__).resolve().parents[1] / "csrc"


def _pretrain_cfg(dtype="float32"):
    """The tiny pretrain config without checkpoint regions; the learning
    rate warms up over its first 10 steps."""
    cfg = tpretrain.tiny_train_config()
    model = tconfig.replace(cfg.model, remat=False, compute_dtype=dtype)
    return tconfig.replace(cfg, model=model, path_remat=False,
                           optim=tconfig.replace(cfg.optim, max_steps=100))


# ---- which steps capture (CPU)

@pytest.mark.parametrize("case, device, remat, path_regions, want", [
    ("alone on a card", "cuda", False, False, True),
    ("cpu", "cpu", False, False, False),
    ("model.remat", "cuda", True, False, False),
    ("path_remat", "cuda", False, True, False),
], ids=["card", "cpu", "model_remat", "path_remat"])
def test_captures_only_on_a_card_without_checkpoint_regions(
        case, device, remat, path_regions, want):
    cfg = _pretrain_cfg()
    cfg = tconfig.replace(cfg, model=tconfig.replace(cfg.model, remat=remat))
    assert tstep.captures_graph(torch.device(device), cfg,
                                path_regions) is want, case


def test_a_process_group_runs_eager(tmp_path):
    """An initialised group, here one gloo rank, keeps the step eager."""
    cfg = _pretrain_cfg()
    assert tstep.captures_graph(torch.device("cuda"), cfg, False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert not tstep.captures_graph(torch.device("cuda"), cfg, False)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("own_loss", [False, True], ids=["pretrain", "own"])
def test_path_remat_counts_only_for_the_default_loss(monkeypatch, own_loss):
    """`path_remat` puts regions in the pretrain loss alone: a step with
    its own loss (the dual and TaskQA fine-tunes) takes none from it. The
    CPU step is the eager step itself, with AdamW as built."""
    cfg = tconfig.replace(_pretrain_cfg(), path_remat=True)
    model, optimizer, scheduler, _ = tpretrain.build_pretrain(cfg, "cpu")
    seen = []
    decide = tstep.captures_graph
    monkeypatch.setattr(tstep, "captures_graph", lambda *a: seen.append(
        a[2]) or decide(*a))
    step = tstep.make_train_step(
        model, cfg, optimizer, scheduler,
        loss_fn=(lambda m, b: None) if own_loss else None)
    assert seen == [not own_loss]
    assert not isinstance(step, tstep.GraphStep)
    assert all(not g["capturable"] and isinstance(g["lr"], float)
               for g in optimizer.param_groups)


def test_capturable_makes_tensor_rates_the_scheduler_fills_in_place():
    """A float learning rate would be frozen into the graph; a 0-d float32
    tensor on the device is filled by the scheduler, the same object every
    step, with the rate a float would have had."""
    model = torch.nn.Linear(3, 2)
    optimizer, scheduler = topt.make_adamw_warmup_cosine(model, 1e-3, 4, 10)
    floats = [topt.warmup_cosine_factor(4, 10)(c) * 1e-3 for c in range(6)]
    model(torch.ones(1, 3)).sum().backward()
    optimizer.step()
    scheduler.step()
    device = torch.device("cpu")
    tstep.capturable_(optimizer, device)
    group = optimizer.param_groups[0]
    lr = group["lr"]
    assert group["capturable"] and lr.dtype == torch.float32 and lr.dim() == 0
    assert all(s["step"].device == device for s in optimizer.state.values())
    tstep.capturable_(optimizer, device)
    assert group["lr"] is lr
    for count in range(2, 6):
        scheduler.step()
        assert group["lr"] is lr
        assert lr.item() == np.float32(floats[count])


def test_categorical_is_multinomial_draw_for_draw():
    gen = torch.Generator().manual_seed(0)
    for seed in range(5):
        w = torch.softmax(torch.randn(16, 16, generator=gen), 1)
        w.fill_diagonal_(0.0)
        a, b = (torch.Generator().manual_seed(seed) for _ in range(2))
        assert torch.equal(categorical(w + 1e-9, a),
                           torch.multinomial(w + 1e-9, 1, generator=b)[:, 0])
        assert torch.equal(a.get_state(), b.get_state())


def test_mining_outside_a_capture_checks_its_weights():
    """Outside a CUDA graph's capture the mining draws with
    `torch.multinomial`, whose checks refuse weights from a non-finite
    similarity."""
    sim = torch.randn(6, 6)
    mask = torch.eye(6, dtype=torch.bool)
    a, b = (torch.Generator().manual_seed(3) for _ in range(2))
    got = mine_itm_indices(a, sim, mask, 0.05)
    assert torch.equal(torch.stack(got), torch.stack(
        mine_itm_indices(b, sim.clone(), mask, 0.05)))
    sim[2, 4] = float("nan")
    with pytest.raises(RuntimeError):
        mine_itm_indices(a, sim, mask, 0.05)


def test_uint8_normalisation_stats_are_built_once():
    cfg = _pretrain_cfg()
    model, _, _, _ = tpretrain.build_pretrain(cfg, "cpu")
    video = torch.randint(0, 256, (2, 2, 32, 32, 3), dtype=torch.uint8)
    tower = model.video_model
    first = tower.patchify(video)
    stats = tower._uint8_stats[video.device]
    assert torch.equal(tower.patchify(video), first)
    assert tower._uint8_stats[video.device] is stats
    assert len(tower._uint8_stats) == 1


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _steps_spans(mark):
    """The span names of each step since `mark`, a list a step."""
    out = {}
    for s in SPANS.records(mark):
        out.setdefault(s.step, []).append(s.name)
    return [names for _, names in sorted(out.items())]


def _engaged(names):
    return ("capture" if CAPTURE in names else "") + (
        "replay" if REPLAY in names else "") or "eager"


def _assert_same_state(a_model, a_opt, b_model, b_opt):
    for (n, p), q in zip(a_model.named_parameters(), b_model.parameters()):
        assert torch.equal(p, q), n
        sa, sb = a_opt.state[p], b_opt.state[q]
        assert set(sa) == set(sb), n
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)
    for ga, gb in zip(a_opt.param_groups, b_opt.param_groups):
        assert torch.equal(ga["lr"], gb["lr"]), ga.get("name")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_step_is_the_eager_step_bit_for_bit(cuda, dtype):
    """Six pretrain steps over a warming learning rate: the first eager,
    the second captures and replays once, the rest replay; each step's
    losses, each group's rate, the parameters and AdamW's state equal an
    eager copy's from the same seed, bit for bit, and the metrics a caller
    held keep their step's values after the later calls."""
    cfg = _pretrain_cfg(dtype)
    g_model, g_opt, _, g_step = tpretrain.build_pretrain(cfg, cuda)
    e_model, e_opt, _, e_step = tpretrain.build_pretrain(cfg, cuda)
    assert isinstance(g_step, tstep.GraphStep)
    batches = [tpretrain.synthetic_batch(cfg, 8, np.random.default_rng(i))
               for i in range(6)]
    mark = SPANS.last
    held, rates = [], []
    for i, b in enumerate(batches):
        got, want = g_step(b), e_step.eager(b)
        held.append((got, want))
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        _assert_same_state(g_model, g_opt, e_model, e_opt)
        rates.append(g_opt.param_groups[0]["lr"].item())
    assert all(a < b for a, b in zip(rates, rates[1:])), rates
    # the calls alternate: the graph step's spans are every other step's
    graph_steps = _steps_spans(mark)[::2]
    assert [_engaged(n) for n in graph_steps] == [
        "eager", "capturereplay", "replay", "replay", "replay", "replay"]
    assert all(n == [STEP, "egovlpv2.step.put", REPLAY]
               for n in graph_steps[2:])
    for i, (got, want) in enumerate(held):
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)


@pytest.mark.gpu
def test_other_shapes_run_eager_between_replays(cuda):
    """A short batch (a loader's last) after the capture drops the graph
    and runs eager; the full batches after it run eager once, then capture
    again and replay; all as an all-eager copy, bit for bit."""
    cfg = _pretrain_cfg()
    g_model, g_opt, _, g_step = tpretrain.build_pretrain(cfg, cuda)
    e_model, e_opt, _, e_step = tpretrain.build_pretrain(cfg, cuda)
    sizes = [8, 8, 8, 5, 8, 8, 8]
    mark = SPANS.last
    for i, n in enumerate(sizes):
        b = tpretrain.synthetic_batch(cfg, n, np.random.default_rng(i))
        got, want = g_step(b), e_step.eager(b)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    _assert_same_state(g_model, g_opt, e_model, e_opt)
    graph_steps = _steps_spans(mark)[::2]
    assert [_engaged(n) for n in graph_steps] == [
        "eager", "capturereplay", "replay", "eager", "eager", "capturereplay",
        "replay"]


@pytest.mark.gpu
def test_a_resumed_graph_step_equals_the_one_that_did_not_stop(cuda):
    """Five steps in one run against three, a save read back on the CPU as
    the CLI's checkpoints are, and two more in a new run: the loaded state
    brings its learning rates as CPU tensors, which the new step makes
    device tensors again before it captures; bit for bit."""
    cfg = _pretrain_cfg()
    batches = [tpretrain.synthetic_batch(cfg, 8, np.random.default_rng(i))
               for i in range(5)]
    a_model, a_opt, _, a_step = tpretrain.build_pretrain(cfg, cuda)
    for b in batches:
        a_step(b)
    b_model, b_opt, b_sched, b_step = tpretrain.build_pretrain(cfg, cuda)
    for b in batches[:3]:
        b_step(b)
    buf = io.BytesIO()
    torch.save(train_state(b_model, b_opt, b_sched, b_step.generator, 3), buf)
    del b_model, b_opt, b_sched, b_step
    buf.seek(0)
    state = torch.load(buf, map_location="cpu", weights_only=False)
    c_model, c_opt, c_sched, c_step = tpretrain.build_pretrain(cfg, cuda)
    assert load_train_state_(state, c_model, c_opt, c_sched,
                             c_step.generator) == 3
    mark = SPANS.last
    for b in batches[3:]:
        c_step(b)
    assert [_engaged(n) for n in _steps_spans(mark)] == [
        "eager", "capturereplay"]
    _assert_same_state(a_model, a_opt, c_model, c_opt)


def _dual(cuda):
    cfg = _pretrain_cfg()
    model = tconfig.replace(cfg.model, projection="small", projection_dim=24,
                            with_itm_head=False, with_mlm_head=False)
    cfg = tconfig.replace(cfg, model=model, tasks="Dual",
                          loss=tconfig.replace(cfg.loss, type="NormSoftmax"),
                          path_remat=True)  # unused by the dual loss
    pair = [tretrieval.build_dual(cfg, cuda) for _ in range(2)]

    def batch(seed):
        rs = np.random.RandomState(seed)
        v = cfg.model.video
        ids = rs.randint(4, cfg.model.text.vocab_size - 2, (6, 10))
        ids[:, 0], ids[:, -1] = 0, 2
        return {"video": rs.randn(6, v.num_frames, v.img_size, v.img_size,
                                  v.in_chans).astype(np.float32),
                "text_ids": ids.astype(np.int32),
                "text_mask": np.ones((6, 10), np.int32)}

    return [(m, o, s) for m, o, _, s in pair], batch


def _taskqa(cuda):
    cfg = _pretrain_cfg().model
    pair = []
    for _ in range(2):
        torch.manual_seed(0)
        model = tqa.make_qa_model(cfg, 5, device=cuda)
        if pair:
            model.load_state_dict(pair[0][0].state_dict())
        optimizer, scheduler = topt.make_adamw_warmup_cosine(model, 1e-3, 8,
                                                             20)
        step = tqa.make_qa_train_step(
            model, optimizer, scheduler,
            torch.Generator(device=cuda).manual_seed(1))
        pair.append((model, optimizer, step))

    def batch(seed):
        rs = np.random.RandomState(seed)
        ids = rs.randint(4, cfg.text.vocab_size - 2, (6, 10))
        ids[:, 0], ids[:, -1] = 0, 2
        return {"video": rs.randn(6, cfg.video.num_frames, cfg.video.img_size,
                                  cfg.video.img_size, cfg.video.in_chans
                                  ).astype(np.float32),
                "text_ids": ids.astype(np.int32),
                "text_mask": np.ones((6, 10), np.int32),
                "answer": rs.randint(0, 5, 6).astype(np.int64)}

    return pair, batch


@pytest.mark.gpu
@pytest.mark.parametrize("build", [_dual, _taskqa], ids=["dual", "taskqa"])
def test_fine_tune_steps_capture_and_replay(cuda, build):
    pair, batch = build(cuda)
    (g_model, g_opt, g_step), (e_model, e_opt, e_step) = pair
    assert isinstance(g_step, tstep.GraphStep)
    mark = SPANS.last
    for i in range(4):
        got, want = g_step(batch(i)), e_step.eager(batch(i))
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    _assert_same_state(g_model, g_opt, e_model, e_opt)
    assert [_engaged(n) for n in _steps_spans(mark)[::2]] == [
        "eager", "capturereplay", "replay", "replay"]


def _hand_kernels():
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
                                src.read_text()))
    return names


def _kernel_counts(fn, hand):
    """The launches of each kernel of `hand` while `fn` runs, by the name
    the profiler gives the device's kernels."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a demangled name: "void (anonymous namespace)::name<...>(...)"
        for name in set(re.findall(r"\w+", e.name)) & hand:
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_hand_kernel_runs_inside_the_replay(cuda, dtype):
    """The hand-written kernels of one replayed step, by name from the
    profiler, are those of one eager step, launch for launch; a replay
    calls no wrapper, so the wrappers' counters gain nothing in it."""
    cfg = _pretrain_cfg(dtype)
    _, _, _, g_step = tpretrain.build_pretrain(cfg, cuda)
    _, _, _, e_step = tpretrain.build_pretrain(cfg, cuda)
    batch = tpretrain.synthetic_batch(cfg, 8, np.random.default_rng(0))
    for _ in range(2):
        g_step(batch)
        e_step.eager(batch)
    hand = _hand_kernels()
    _kernels.reset_launch_counts()
    replayed = _kernel_counts(lambda: g_step(batch), hand)
    counted = dict(_kernels.launch_counts)
    _kernels.reset_launch_counts()
    eager = _kernel_counts(lambda: e_step.eager(batch), hand)
    assert replayed == eager and replayed
    assert not any(counted.values()) and any(_kernels.launch_counts.values())
    print(f"{dtype}: {sorted(replayed.items())}")


@pytest.mark.gpu
@pytest.mark.parametrize("release", ["drop_the_step", "other_shapes"])
def test_dropping_the_step_returns_its_pool(cuda, release):
    """The graph's memory pool goes back to the device when the step is
    dropped with the model and the optimizer, and when a batch of other
    shapes comes after the capture (before its eager step runs): the
    allocator's reserve falls back near where it was before the step was
    built (wider frames make the pool the bulk of it; the short batch's
    own working set is small)."""
    cfg = _pretrain_cfg()
    video = tconfig.replace(cfg.model.video, img_size=224)
    cfg = tconfig.replace(cfg, model=tconfig.replace(cfg.model, video=video))
    full, short = (tpretrain.synthetic_batch(cfg, n, np.random.default_rng(0))
                   for n in (32, 2))

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    before = reserved()
    trainer = tpretrain.build_pretrain(cfg, cuda)
    for _ in range(3):
        trainer[3](full)
    assert isinstance(trainer[3], tstep.GraphStep)
    held = reserved()
    if release == "other_shapes":
        trainer[3](short)
        assert trainer[3].graph is None
    else:
        del trainer
    after = reserved()
    print(f"{release}: reserved MiB before {before / 2**20:.1f}, with the "
          f"graph {held / 2**20:.1f}, after {after / 2**20:.1f}")
    assert held - before > 64 * 2**20
    assert after - before < 0.25 * (held - before)


@pytest.mark.gpu
def test_categorical_is_multinomial_draw_for_draw_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for seed in range(5):
        w = torch.softmax(torch.randn(64, 64, generator=gen, device=cuda), 1)
        w.fill_diagonal_(0.0)
        a, b = (torch.Generator(device=cuda).manual_seed(seed)
                for _ in range(2))
        assert torch.equal(categorical(w + 1e-9, a),
                           torch.multinomial(w + 1e-9, 1, generator=b)[:, 0])
        assert torch.equal(a.get_state(), b.get_state())
