"""The port's own copies of the JAX package's framework-free modules give
what the originals give: the config tree and its loader, the tokenizer
adapter, the MLM collator, the synthetic batches and the EgoMCQ metric.
And the port imports nothing of the JAX package."""

import argparse
import dataclasses
import glob
import os
from pathlib import Path

import numpy as np
import pytest

from egovlpv2_tpu import cli as jcli
from egovlpv2_tpu.core import config as jconfig
from egovlpv2_tpu.data import loader as jloader
from egovlpv2_tpu.data import mlm as jmlm
from egovlpv2_tpu.metrics import retrieval as jmetrics
from egovlpv2_tpu.tasks import pretrain as jpretrain
from egovlpv2_torch import cli as tcli
from egovlpv2_torch.core import config as tconfig
from egovlpv2_torch.data import mlm as tmlm
from egovlpv2_torch.data import tokenizer as ttokenizer
from egovlpv2_torch.metrics import retrieval as tmetrics
from egovlpv2_torch.tasks import pretrain as tpretrain

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(str(ROOT / "configs" / "*.json")))
OVERRIDES = ["model.video.num_frames=16", "optim.betas=[0.9, 0.95]",
             "loss.type=NormSoftmax", "path_remat=false", "optim.lr=1e-4"]


def test_there_are_configs_to_compare():
    assert len(CONFIGS) >= 7


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "set"])
def test_config_file_loads_alike(name, overrides):
    path = str(ROOT / "configs" / name)
    ref = jcli.load_train_config(path, overrides)
    got = tconfig.load_train_config(path, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert tconfig.to_json(got) == jconfig.to_json(ref)


def test_config_defaults_properties_and_errors_alike(tmp_path):
    ref, got = jconfig.TrainConfig(), tconfig.TrainConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfig.load_train_config()) == dataclasses.asdict(ref)
    for part in ("video", "text"):
        assert getattr(got.model, part).head_dim == getattr(ref.model, part).head_dim
    assert got.model.video.seq_len == ref.model.video.seq_len == 785
    assert got.model.video.patches_per_frame == 196
    assert got.model.num_unfused == ref.model.num_unfused == 6
    assert tconfig.NORM_STATS == jconfig.NORM_STATS
    assert tconfig.replace(got, seed=3).seed == 3
    bad = tmp_path / "bad.json"
    bad.write_text('{"_doc": "a comment key", "modle": {}}')
    for load in (jcli.load_train_config, tconfig.load_train_config):
        with pytest.raises(KeyError, match="modle"):
            load(str(bad))


@pytest.mark.parametrize("vocab_cap", [None, 300])
def test_tokenizer_matches(vocab_cap, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    texts = ["someone does something", "C picks up the knife and cuts a tomato "
             "on the chopping board near the sink", "", "Washes HANDS"]
    ref = jloader.Tokenizer("roberta-base", max_len=15, vocab_cap=vocab_cap)
    got = ttokenizer.Tokenizer("roberta-base", max_len=15, vocab_cap=vocab_cap)
    assert (got._tok is None) == (ref._tok is None)
    for a, b in ((ref(texts), got(texts)),
                 (ref._cap(ref._fallback(texts)), got._cap(got._fallback(texts)))):
        assert set(a) == set(b) == {"text_ids", "text_mask"}
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_mask_tokens_matches():
    ids = np.random.default_rng(0).integers(0, 50265, (64, 15))
    ids[:, 0], ids[:, -1] = 0, 2
    for seed, kw in ((1, {}), (2, dict(mlm_prob=0.5, mask_id=255, vocab_size=256))):
        ref = jmlm.mask_tokens(ids, np.random.default_rng(seed), **kw)
        got = tmlm.mask_tokens(ids, np.random.default_rng(seed), **kw)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
    assert (ref[1] != -100).any() and (ref[1] == -100).any()


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full_width_8f"])
def test_synthetic_batch_matches(tiny):
    if tiny:
        jcfg, tcfg = jpretrain.tiny_train_config(), tpretrain.tiny_train_config()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    else:  # full vocabulary and text length; small frames keep it light
        sets = ["model.video.img_size=32", "model.video.num_frames=8"]
        jcfg = jcli.load_train_config(None, sets)
        tcfg = tconfig.load_train_config(None, sets)
    for seed in (0, 5):
        ref = jpretrain.synthetic_batch(jcfg, 6, np.random.default_rng(seed))
        got = tpretrain.synthetic_batch(tcfg, 6, np.random.default_rng(seed))
        assert list(ref) == list(got)
        for key in ref:
            assert ref[key].dtype == got[key].dtype, key
            np.testing.assert_array_equal(ref[key], got[key], err_msg=key)
    assert (tpretrain.NOUN_DIM, tpretrain.VERB_DIM) == (jpretrain.NOUN_DIM,
                                                        jpretrain.VERB_DIM)


def test_egomcq_accuracy_matches():
    rng = np.random.default_rng(3)
    preds = rng.standard_normal((40, 5))
    labels = rng.integers(0, 5, 40)
    for types in (rng.integers(1, 3, 40), np.ones(40, np.int64)):
        assert (tmetrics.egomcq_accuracy(preds, labels, types)
                == jmetrics.egomcq_accuracy(preds, labels, types))


def _metric_cases():
    """name -> arguments, from one seed: similarities with ties, a
    relevancy matrix with a 1 in every row and column, multi-hot targets
    with an empty row and an empty class."""
    rng = np.random.default_rng(11)
    sims = np.round(rng.standard_normal((12, 12)), 1)  # rounded: ties
    sims20 = rng.standard_normal((20, 10))  # two captions a video
    mask = rng.random(20) < 0.8
    mask[::2] = True  # every video keeps a caption
    rel = np.round(rng.random((9, 7)), 2)
    rel[np.arange(9), rng.integers(0, 7, 9)] = 1.0
    rel[rng.integers(0, 9, 7), np.arange(7)] = 1.0
    sim_vt = rng.standard_normal((9, 7))
    gt = (rng.random((30, 6)) < 0.3).astype(np.int64)
    gt[0], gt[:, 5] = 0, 0
    gt[1, :5] = 1
    sub = rng.standard_normal((30, 6))
    preds = rng.standard_normal((15, 4))
    labels = rng.integers(0, 4, 15)
    return {
        "t2v_metrics": [(sims,), (sims20,), (sims20, mask)],
        "v2t_metrics": [(sims,), (sims20,), (sims20, mask)],
        "calculate_k_counts": [(rel,)],
        "calculate_nDCG": [(sim_vt, rel), (sim_vt, rel, None, None, "none")],
        "calculate_mAP": [(sim_vt, rel)],
        "mir_metrics": [(sim_vt, rel)],
        "oscc_accuracy": [(preds, labels)],
        "pnr_distance": [(preds, labels), (preds, labels, np.full(15, 30.0))],
        "per_class_ap": [(sub, gt)],
        "charades_map": [(sub, gt)],
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_retrieval_metric_copy_matches(name):
    """Each function of the port's `metrics/retrieval.py` gives what its
    original gives, exactly (the same numpy calls on the same inputs)."""

    def same(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for key in a:
                same(a[key], b[key])
        elif isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    for args in _metric_cases()[name]:
        with np.errstate(invalid="ignore", divide="ignore"):
            same(getattr(tmetrics, name)(*args), getattr(jmetrics, name)(*args))
    public = lambda m: {n for n, f in vars(m).items()
                        if callable(f) and not n.startswith("_")
                        and getattr(f, "__module__", "") == m.__name__}
    assert public(tmetrics) == public(jmetrics) >= set(_metric_cases())


def test_synthetic_egomcq_batches_match(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    sets = ["model.video.img_size=32", "model.video.num_frames=2",
            "model.text.vocab_size=120"]
    args = argparse.Namespace(val_batches=2, meta=None, val_meta=None)
    ref = jcli._make_egomcq_batches(args, jcli.load_train_config(None, sets),
                                    "roberta-base", batch_size=3)
    got = tcli._synthetic_egomcq_batches(
        tconfig.load_train_config(None, sets), "roberta-base", 3, 2)
    for epoch in (0, 1):
        a, b = list(ref(epoch)), list(got(epoch))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert list(x) == list(y)
            for key in x:
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_port_sources_name_no_import_of_the_jax_package():
    files = list((ROOT / "egovlpv2_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", *(ROOT / "scripts").glob("profile_torch_*.py")]
    assert len(files) > 30
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words and words[0] in ("import", "from"):
                assert "egovlpv2_tpu" not in line and "jax" not in line, (path, line)
