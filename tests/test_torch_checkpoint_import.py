"""The reference-checkpoint importer of egovlpv2_torch
(`train/checkpoint_import.py`) against egovlpv2_tpu's on the CPU: one seeded
state_dict under the reference's names goes through both importers and must
give the same tensors, the same report and the same EgoMCQ scores; the
`--ckpt` flag of the port's commands end to end."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.core.config import replace
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.tasks import egomcq as jtask
from egovlpv2_tpu.train import checkpoint_import as jimp
from egovlpv2_torch import cli
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks import egomcq as ttask
from egovlpv2_torch.train import checkpoint_import as timp
from egovlpv2_torch.weights import state_dict_from_flax
from test_checkpoint_import import CFG, fake_reference_state_dict

torch.set_num_threads(2)

# CFG as --set overrides of the port's commands
CFG_OVERRIDES = [
    "model.video.img_size=32", "model.video.embed_dim=32",
    "model.video.depth=4", "model.video.num_heads=2",
    "model.video.num_frames=2", "model.text.vocab_size=100",
    "model.text.hidden_size=32", "model.text.num_layers=4",
    "model.text.num_heads=2", "model.text.intermediate_size=64",
    "model.text.max_position_embeddings=40", "model.fusion.num_fuse_block=2",
    "model.fusion.dim_video=32", "model.fusion.dim_text=32",
    "model.fusion.hidden_size=32", "model.projection_dim=16",
]


def _jax_params(cfg):
    model = JaxEgoVLPv2(cfg)
    v = cfg.video
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, v.num_frames, v.img_size, v.img_size, 3)),
        jnp.array([[0, 5, 2, 1]], jnp.int32), jnp.array([[1, 1, 1, 0]], jnp.int32),
        method=model.init_all)["params"]
    return model, params


def _both(cfg, sd, **kw):
    """(flax params, report) of the JAX importer and (state_dict, report) of
    the port's, from one reference dict onto one initialisation."""
    _, params = _jax_params(cfg)
    jparams, jreport = jimp.import_reference_checkpoint(
        sd, params, num_frames=cfg.video.num_frames, **kw)
    start = state_dict_from_flax(params)
    tmodel = EgoVLPv2(cfg)
    tmodel.load_state_dict(start, strict=True)
    tsd, treport = timp.import_reference_checkpoint(
        sd, tmodel.state_dict(), num_frames=cfg.video.num_frames, **kw)
    return jparams, jreport, tsd, treport


def _assert_same(jparams, jreport, tsd, treport):
    ref = state_dict_from_flax(jparams)
    assert set(ref) == set(tsd)
    for name, tensor in ref.items():
        assert tsd[name].dtype == torch.float32
        assert torch.equal(tsd[name], tensor), name
    assert set(jreport) == set(treport)
    for key in jreport:
        assert sorted(jreport[key]) == sorted(treport[key]), key


@pytest.mark.parametrize("case", ["module_prefix", "plain_names",
                                  "inflate_3_frames", "truncate_1_frame",
                                  "zeros_4_frames"])
def test_importers_give_the_same_tensors_and_report(case):
    sd = fake_reference_state_dict(np.random.RandomState(7))
    cfg, kw = CFG, {}
    if case == "module_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    frames = {"inflate_3_frames": 3, "truncate_1_frame": 1,
              "zeros_4_frames": 4}.get(case)
    if frames:
        cfg = replace(CFG, video=replace(CFG.video, num_frames=frames))
    if case == "zeros_4_frames":
        kw["temporal_fix"] = "zeros"
    jparams, jreport, tsd, treport = _both(cfg, sd, **kw)
    _assert_same(jparams, jreport, tsd, treport)
    assert not treport["skipped"] and not treport["missing_in_checkpoint"]
    assert not treport["unused_checkpoint_keys"]
    assert len(treport["imported"]) == len(tsd)
    assert tuple(tsd["video_model.temporal_embed"].shape) == (
        1, cfg.video.num_frames, 32)
    EgoVLPv2(cfg).load_state_dict(tsd, strict=True)


def test_importers_agree_on_what_does_not_fit():
    """A dual model (small projection, no heads) under a checkpoint with
    heads and a buffer, a tensor of another size, and a missing one: the
    same skipped, missing and unused entries, and strict raises in both."""
    sd = fake_reference_state_dict(np.random.RandomState(8))
    sd["text_model.embeddings.position_ids"] = np.arange(40)[None]  # a buffer
    sd["stray.weight"] = np.zeros(3, np.float32)
    sd["video_model.norm.weight"] = np.zeros(33, np.float32)  # another size
    del sd["video_model.blocks.1.mlp.fc2.bias"]
    cfg = replace(CFG, projection="small", with_itm_head=False,
                  with_mlm_head=False)
    jparams, jreport, tsd, treport = _both(cfg, sd)
    _assert_same(jparams, jreport, tsd, treport)
    assert "itm_score.fc.kernel" in treport["skipped"]
    assert "video_model.norm.scale (shape (33,) vs (32,))" in treport["skipped"]
    # the checkpoint's 'minimal' first projection layer has no bias
    assert sorted(treport["missing_in_checkpoint"]) == [
        "txt_proj.fc0.bias", "vid_proj.fc0.bias",
        "video_model.blocks_1.mlp.fc2.bias"]
    assert treport["unused_checkpoint_keys"] == ["stray.weight"]
    _, params = _jax_params(cfg)
    with pytest.raises(ValueError, match="import mismatch"):
        jimp.import_reference_checkpoint(sd, params, strict=True)
    with pytest.raises(ValueError, match=r"import mismatch.*stray\.weight"):
        timp.import_reference_checkpoint(sd, tsd, strict=True)


def test_layouts_come_out_as_the_port_keeps_them():
    sd = fake_reference_state_dict(np.random.RandomState(9))
    tsd, _ = timp.import_reference_checkpoint(
        sd, EgoVLPv2(CFG).state_dict(), num_frames=2)
    # a Linear weight stays [out, in]; the patch kernel goes OIHW -> HWIO
    np.testing.assert_array_equal(
        tsd["video_model.blocks.0.attn.qkv.weight"].numpy(),
        sd["video_model.blocks.0.attn.qkv.weight"])
    np.testing.assert_array_equal(
        tsd["video_model.patch_embed.weight"].numpy(),
        sd["video_model.patch_embed.proj.weight"].transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(
        tsd["text_model.layer.2.crossattention_t2i.query.weight"].numpy(),
        sd["text_model.encoder.layer.2.crossattention_t2i.self.query.weight"])
    np.testing.assert_array_equal(
        tsd["text_model.embeddings.word_embeddings.weight"].numpy(),
        sd["text_model.embeddings.word_embeddings.weight"])
    np.testing.assert_array_equal(tsd["mlm_score.decoder.weight"].numpy(),
                                  sd["mlm_score.decoder.weight"])
    assert tsd["video_model.blocks.2.attn.alpha_i2t"].item() == np.float32(0.3)
    assert tsd["text_model.layer.2.alpha_t2i"].item() == np.float32(0.2)


@pytest.mark.parametrize("frames, mode", [(2, "bilinear"), (4, "bilinear"),
                                          (6, "zeros"), (7, "bilinear")])
def test_inflate_temporal_embed_matches_jax(frames, mode):
    """Truncation, the unchanged case, zero padding and the interpolation."""
    emb = np.random.RandomState(frames).randn(1, 4, 6).astype(np.float32)
    got = timp.inflate_temporal_embed(emb, frames, mode)
    ref = jimp.inflate_temporal_embed(emb, frames, mode)
    assert got.shape == (1, frames, 6) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_strip_module_prefix_matches_jax():
    for sd in ({"module.a": 1, "module.b.c": 2}, {"module.a": 1, "b": 2}, {}):
        assert timp.strip_module_prefix(sd) == jimp.strip_module_prefix(sd)


def _egomcq_batch():
    rs = np.random.RandomState(11)
    ids = rs.randint(3, 100, (2, 6)).astype(np.int32)
    ids[:, 0] = 0
    ids[0, 4:] = 1
    return rs.randn(2, 5, 2, 32, 32, 3).astype(np.float32), ids, \
        (ids != 1).astype(np.int32)


def test_imported_models_give_the_same_egomcq_scores():
    sd = fake_reference_state_dict(np.random.RandomState(7))
    cfg = replace(CFG, attn_impl="xla")
    jparams, _, tsd, _ = _both(cfg, sd)
    tmodel = EgoVLPv2(cfg)
    tmodel.load_state_dict(tsd, strict=True)
    video5, ids, mask = _egomcq_batch()
    ref = jtask.make_egomcq_eval_step(JaxEgoVLPv2(cfg))(jparams, video5, ids,
                                                       mask)
    got = ttask.make_egomcq_eval_step(tmodel.eval())(video5, ids, mask)
    for key in ("vtc", "vtm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def _save_pth(tmp_path, sd, wrap):
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    path = tmp_path / "reference.pth"
    torch.save({"state_dict": tensors, "epoch": 3} if wrap else tensors, path)
    return str(path)


@pytest.mark.parametrize("wrap", [True, False])
def test_load_torch_state_dict_reads_both_file_layouts(tmp_path, wrap):
    sd = fake_reference_state_dict(np.random.RandomState(12))
    got = timp.load_torch_state_dict(_save_pth(tmp_path, sd, wrap))
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])


def test_cli_egomcq_ckpt_end_to_end(tmp_path, capsys):
    """`egomcq --ckpt file.pth` scores with the imported weights: the same
    scores as a model loaded through the importer by hand, and other scores
    than the seeded initialisation's."""
    sd = {"module." + k: v for k, v in
          fake_reference_state_dict(np.random.RandomState(7)).items()}
    path = _save_pth(tmp_path, sd, wrap=True)
    base = ["egomcq", "--device", "cpu", "--batch_size", "2", "--val_batches",
            "1", "--set", *CFG_OVERRIDES]
    with_ckpt = cli.main(base + ["--ckpt", path])
    assert "imported 213 tensors" in capsys.readouterr().out
    seeded = cli.main(base)
    assert not np.allclose(with_ckpt["scores"]["vtm"], seeded["scores"]["vtm"])
    model = EgoVLPv2(CFG)
    tsd, report = timp.import_reference_checkpoint(sd, model.state_dict(),
                                                   num_frames=2)
    assert len(report["imported"]) == 213
    model.load_state_dict(tsd, strict=True)
    batch = next(cli._make_egomcq_batches(
        argparse.Namespace(meta=None, val_batches=1),
        cli.load_train_config(None, CFG_OVERRIDES), "roberta-base", 2)(0))
    ref = ttask.make_egomcq_eval_step(model.eval())(
        batch["video5"], batch["ids"], batch["mask"])
    for key in ("vtc", "vtm"):
        np.testing.assert_allclose(with_ckpt["scores"][key], ref[key].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_cli_extract_and_trainers_take_ckpt(tmp_path):
    sd = fake_reference_state_dict(np.random.RandomState(7))
    path = _save_pth(tmp_path, sd, wrap=False)
    out = tmp_path / "feats"
    res = cli.main(["extract", "--device", "cpu", "--synthetic", "5", "--out",
                    str(out), "--inner_batch", "2", "--input_res", "32",
                    "--ckpt", path, "--set", *CFG_OVERRIDES])
    feats = res["features"]["synthetic"]
    assert feats.shape == (3, 16) and np.isfinite(feats).all()
    np.testing.assert_array_equal(
        res["model"].state_dict()["vid_proj.fc2.weight"].numpy(),
        sd["vid_proj.4.weight"])
    res = cli.main(["pretrain", "--synthetic", "--device", "cpu", "--ckpt",
                    path, "--steps_per_epoch", "1", "--set", *CFG_OVERRIDES,
                    "global_batch_size=2", "optim.lr=0.0"])
    assert np.isfinite(res["logged"][0]["loss_total"])
    np.testing.assert_array_equal(
        res["model"].state_dict()["itm_score.fc.weight"].numpy(),
        sd["itm_score.fc.weight"])
    # a directory is read as a training run's checkpoints: the .pth in
    # tmp_path is none of them
    with pytest.raises(FileNotFoundError, match="no checkpoint found under"):
        cli.main(["extract", "--device", "cpu", "--synthetic", "5", "--out",
                  str(out), "--ckpt", str(tmp_path)])
