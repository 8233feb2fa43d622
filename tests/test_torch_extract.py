"""The feature-extraction slice of egovlpv2_torch (`tasks/extract.py`,
`tasks/qfvs_extract.py`, the KTS part of `downstream/qfvs.py`, `cli
extract`) against egovlpv2_tpu on the CPU: the same parameters and frames,
float32, every output within 1e-4 of max |reference| of its tensor (at
least 1: features behind a LayerNorm are of order 1, the unfused tokens of
order 10, and float32 sums in another order move them by that much)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.core.config import replace
from egovlpv2_tpu.downstream import qfvs as jqfvs
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.tasks import extract as jext
from egovlpv2_tpu.tasks import qfvs_extract as jqext
from egovlpv2_torch import cli
from egovlpv2_torch.data.tokenizer import Tokenizer
from egovlpv2_torch.downstream import qfvs as tqfvs
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks import extract as text
from egovlpv2_torch.tasks import qfvs_extract as tqext
from torch_parity import TINY, TINY_OVERRIDES, load_flax, perturb

torch.set_num_threads(2)

TOL = 1e-4


def _assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{err_msg}: error {err} > {bound}"


def _models(cfg, seed=1):
    cfg = replace(cfg, attn_impl="xla")
    jmodel = JaxEgoVLPv2(cfg)
    v = cfg.video
    params = jmodel.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, v.num_frames, v.img_size, v.img_size, 3)),
        jnp.zeros((1, 6), jnp.int32), jnp.ones((1, 6), jnp.int32),
        method=jmodel.init_all)["params"]
    params = perturb(params, seed=seed)
    return jmodel, params, load_flax(EgoVLPv2(cfg), params)


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


@pytest.fixture(scope="module")
def tokenizer():
    return Tokenizer("roberta-base", max_len=8, vocab_cap=TINY.text.vocab_size)


def _frames(seed, t, dtype=np.float32):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (t, 32, 32, 3)).astype(np.uint8)
    return rs.randn(t, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("t, num_frames", [(11, 2), (8, 4), (1, 3)])
def test_window_frames_matches_jax(t, num_frames):
    frames = _frames(0, t)
    np.testing.assert_array_equal(text.window_frames(frames, num_frames),
                                  jext.window_frames(frames, num_frames))


@pytest.mark.parametrize("t, inner_batch, device_norm", [
    (11, 4, None),        # 6 windows: a padded frame and a padded inner batch
    (8, 4, None),         # 4 windows: one whole inner batch
    (5, 2, "imagenet"),   # uint8 frames normalised on the device
    (5, 2, "epic"),
])
def test_clip_features_match_jax(tiny, t, inner_batch, device_norm):
    jmodel, params, tmodel = tiny
    frames = _frames(1, t, np.uint8 if device_norm else np.float32)
    ref = jext.FeatureExtractor(jmodel, params, inner_batch=inner_batch,
                                device_norm=device_norm).clip_features(frames, 2)
    ex = text.FeatureExtractor(tmodel, inner_batch=inner_batch,
                               device_norm=device_norm)
    got = ex.clip_features(frames, 2)
    assert got.shape == (-(-t // 2), TINY.projection_dim)
    assert got.dtype == np.float32
    _assert_close(got, np.asarray(ref))
    n_batches = -(-got.shape[0] // inner_batch)
    assert [shape for shape, _ in ex.batch_log] \
        == [(inner_batch, 2, 32, 32, 3)] * n_batches
    assert all(ms > 0 for _, ms in ex.batch_log)


def test_uint8_frames_without_device_norm_take_the_models_regime(tiny):
    jmodel, params, tmodel = tiny
    frames = _frames(2, 4, np.uint8)
    ref = jext.FeatureExtractor(jmodel, params, inner_batch=2).clip_features(
        frames, 2)
    got = text.FeatureExtractor(tmodel, inner_batch=2).clip_features(frames, 2)
    _assert_close(got, np.asarray(ref))


@pytest.mark.parametrize("per_window", [False, True])
def test_fused_window_features_and_text_tokens_match_jax(tiny, tokenizer,
                                                         per_window):
    jmodel, params, tmodel = tiny
    frames = _frames(3, 9)  # 5 windows, inner batch 2: the tail padded
    enc = tokenizer(["where did I put the keys", "a cup", "what colour was it",
                     "who", "how many plates are on the table"])
    ids, mask = enc["text_ids"], enc["text_mask"]
    if not per_window:
        ids, mask = ids[0], mask[0]
    jex = jext.FeatureExtractor(jmodel, params, inner_batch=2)
    tex = text.FeatureExtractor(tmodel, inner_batch=2)
    ref = jex.fused_window_features(frames, 2, ids, mask)
    got = tex.fused_window_features(frames, 2, ids, mask)
    assert got.shape == (5, TINY.video.embed_dim)
    _assert_close(got, np.asarray(ref))
    ref = jex.text_tokens(enc["text_ids"], enc["text_mask"])
    got = tex.text_tokens(enc["text_ids"], enc["text_mask"])
    assert got.shape == (5, 8, TINY.text.hidden_size)
    _assert_close(got, np.asarray(ref))


def test_extract_nlq_features_writes_the_same_files(tiny, tokenizer, tmp_path):
    jmodel, params, tmodel = tiny
    clips = {"clipA": _frames(4, 7), "clipB": _frames(5, 4)}
    records = [
        {"clip_uid": "clipA", "annotation_uid": "ann0", "query_idx": 0,
         "query": "where is the knife"},
        {"clip_uid": "clipB", "annotation_uid": "ann1", "query_idx": 2,
         "query": "what did I pour"},
        {"clip_uid": "clipA", "annotation_uid": "ann0", "query_idx": 1,
         "query": "who opened the door"},
    ]
    reads = []

    def frames_fn(uid):
        reads.append(uid)
        return clips[uid]

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref_n = jext.extract_nlq_features(
        jext.FeatureExtractor(jmodel, params, inner_batch=2), tokenizer,
        records, frames_fn, 2, jdir)
    del reads[:]
    got_n = text.extract_nlq_features(
        text.FeatureExtractor(tmodel, inner_batch=2), tokenizer, records,
        frames_fn, 2, tdir)
    assert got_n == ref_n == {"clipA": 4, "clipB": 2}
    assert reads == ["clipA", "clipB"]  # each clip is read once
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == 12
    for name in names:
        if name.endswith(".npy"):
            got = np.load(os.path.join(tdir, name))
            _assert_close(got, np.load(os.path.join(jdir, name)))
            pt = torch.load(os.path.join(tdir, name[:-4] + ".pt"))
            np.testing.assert_array_equal(pt.numpy(), got)
    assert np.load(os.path.join(tdir, "clipA_ann0_1.npy")).shape == (4, 64)
    assert np.load(os.path.join(tdir, "clipA_ann0_1_query.npy")).shape == (8, 64)


@pytest.mark.parametrize("suffix", ["", ".npy", ".pt"])
def test_save_features_writes_npy_and_pt(tmp_path, suffix):
    feats = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    text.save_features(str(tmp_path / "sub" / ("clip" + suffix)), feats)
    np.testing.assert_array_equal(np.load(tmp_path / "sub" / "clip.npy"), feats)
    np.testing.assert_array_equal(
        torch.load(tmp_path / "sub" / "clip.pt").numpy(), feats)


@pytest.fixture(scope="module")
def five_frames():
    cfg = replace(TINY, video=replace(TINY.video, num_frames=5))
    return _models(cfg, seed=2)


@pytest.mark.parametrize("t, inner_batch", [(23, 2), (20, 4)])
def test_qfvs_extract_video_matches_jax(five_frames, tokenizer, t, inner_batch):
    """Stage 1, KTS and stage 2: 5 clips (the last frame-padded at t=23)
    through inner batches whose tail is padded."""
    jmodel, params, tmodel = five_frames
    frames = _frames(7, t)
    frames[10:] += 3.0  # a cut to another scene after two clips
    concepts, oracle = ["cup", "street"], "There is a cup and a street"
    ref = jqext.QFVSExtractor(jmodel, params, inner_batch=inner_batch
                              ).extract_video(frames, tokenizer, concepts,
                                              oracle, max_segments=4)
    ex = tqext.QFVSExtractor(tmodel, inner_batch=inner_batch)
    got = ex.extract_video(frames, tokenizer, concepts, oracle, max_segments=4)
    n_clips = -(-t // 5)
    assert got["num_shots"] == ref["num_shots"] == n_clips
    assert len(ref["change_points"]) > 0
    np.testing.assert_array_equal(got["change_points"], ref["change_points"])
    assert list(got["features"]) == list(ref["features"]) == concepts + [oracle]
    for name, feats in got["features"].items():
        assert feats.shape == (n_clips, TINY.fusion.hidden_size)
        _assert_close(feats, np.asarray(ref["features"][name]), name)
    # the stages one by one
    jex = jqext.QFVSExtractor(jmodel, params, inner_batch=inner_batch)
    tokens = ex.unfused_clip_tokens(frames)
    assert tokens.shape == (n_clips, 1 + 5 * 4, TINY.video.embed_dim)
    _assert_close(tokens, np.asarray(jex.unfused_clip_tokens(frames)))
    t_ref, m_ref = jex.concept_text_tokens(tokenizer, concepts)
    t_got, m_got = ex.concept_text_tokens(tokenizer, concepts)
    _assert_close(t_got, t_ref)
    np.testing.assert_array_equal(m_got, m_ref)


def test_qfvs_extractor_needs_five_frames(tiny):
    with pytest.raises(ValueError, match="num_frames >= 5"):
        tqext.QFVSExtractor(tiny[2])
    assert tqext.FRAMES_PER_CLIP == jqext.FRAMES_PER_CLIP == 5


@pytest.mark.parametrize("n, ncp, vmax", [(12, 5, 1.0), (30, 19, 1.0),
                                          (9, 3, 0.2), (2, 1, 1.0)])
def test_cpd_auto_matches_its_original(n, ncp, vmax):
    feats = np.random.RandomState(n).randn(n, 16)
    feats[n // 2:] += 2.0  # a change half-way
    K = feats @ feats.T
    np.testing.assert_array_equal(tqfvs.calc_scatters(K), jqfvs.calc_scatters(K))
    for backtrack in (True, False):
        got = tqfvs.cpd_nonlin(K, ncp, backtrack=backtrack)
        ref = jqfvs.cpd_nonlin(K, ncp, backtrack=backtrack)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    got_cps, got_costs = tqfvs.cpd_auto(K, ncp, vmax)
    ref_cps, ref_costs = jqfvs.cpd_auto(K, ncp, vmax)
    np.testing.assert_array_equal(got_cps, ref_cps)
    np.testing.assert_array_equal(got_costs, ref_costs)


def test_cli_extract_synthetic_on_cpu(tmp_path, capsys):
    out = tmp_path / "feats"
    res = cli.main(["extract", "--device", "cpu", "--synthetic", "11", "--out",
                    str(out), "--inner_batch", "4", "--input_res", "32",
                    "--set", *TINY_OVERRIDES])
    feats = res["features"]["synthetic"]
    assert feats.shape == (6, 16) and np.isfinite(feats).all()
    np.testing.assert_array_equal(np.load(out / "synthetic.npy"), feats)
    np.testing.assert_array_equal(torch.load(out / "synthetic.pt").numpy(), feats)
    assert [shape for shape, _ in res["inner_batches"]] == [(4, 2, 32, 32, 3)] * 2
    printed = capsys.readouterr().out
    assert "synthetic: (6, 16)" in printed and '"inner_batches"' in printed
    # the same frames through the extractor by hand: uint8 in, ImageNet
    # statistics on the device
    frames = np.random.default_rng(0).integers(0, 256, (11, 32, 32, 3),
                                               dtype=np.uint8)
    ref = text.FeatureExtractor(res["model"], inner_batch=3,
                                device_norm="imagenet").clip_features(frames, 2)
    np.testing.assert_allclose(feats, ref, rtol=1e-5, atol=1e-5)


def test_cli_extract_refuses_what_is_not_ported(tmp_path):
    """A --ckpt directory holding no checkpoint of a training run raises
    FileNotFoundError; so do a --videos glob that matches no file, and a
    call with neither --videos nor --synthetic raises ValueError."""
    base = ["extract", "--device", "cpu", "--out", str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="no checkpoint found under"):
        cli.main(base + ["--synthetic", "4", "--ckpt", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="no videos match"):
        cli.main(base + ["--videos", str(tmp_path / "clips" / "*.mp4")])
    with pytest.raises(ValueError, match="--synthetic"):
        cli.main(base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["extract", "--synthetic", "4", "--out", str(tmp_path)])
