"""The port's commands on files (`egovlpv2_torch/cli.py`), on the CPU at the
tiny widths of the JAX CLI's tests, from videos, frames and metadata written
here: `pretrain --meta` (one file and a comma list, scene negatives, with
and without `--device_norm`), `egomcq --meta`, `ft-charades --meta` and
`ft-epic --meta` with their validations, and `extract --videos`. They
mirror `tests/test_cli.py` (its `--save_dir` runs are ported in
`tests/test_torch_training_loop.py`) and hold one pretrain step from generated mp4s to the JAX step: the
same collated batch through both packages' pipelines, the same weights,
the losses within 1e-4 in f32."""

import argparse
import json
import pickle
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")

from egovlpv2_tpu.data import datasets as jdatasets  # noqa: E402
from egovlpv2_tpu.data import loader as jloader  # noqa: E402
from egovlpv2_torch import cli  # noqa: E402
from egovlpv2_torch.data import datasets as tdatasets  # noqa: E402
from egovlpv2_torch.data import loader as tloader  # noqa: E402
from egovlpv2_torch.data.tokenizer import Tokenizer  # noqa: E402
from tests.test_cli import TINY, _write_egoclip_fixture, _write_mp4  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture()
def tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _egoclip(tmp_path):
    data, rows = _write_egoclip_fixture(tmp_path)
    meta = tmp_path / "egoclip.csv"
    meta.write_text("\n".join(rows))
    return data, rows, meta


def _finite(rows, key="loss_total"):
    return rows and all(np.isfinite(r[key]) for r in rows)


@pytest.mark.parametrize("device_norm", [False, True],
                         ids=["host_norm", "device_norm"])
def test_pretrain_from_generated_mp4s(tiny_config, tmp_path, device_norm,
                                      monkeypatch):
    """The data path end to end: chunked EgoClip mp4s -> the OpenCV chunk
    reader -> the train transform (uint8 with --device_norm) -> the
    threaded loader with scene negatives, tokenizing and MLM masking ->
    `device_prefetch` with the device's put -> the train step. 8 rows at a
    loader batch of 4 (8 / 2, the negatives double it) are 2 steps, each
    fed a `DeviceBatch` of 8 rows."""
    data, _, meta = _egoclip(tmp_path)
    fed, prefetched = [], []
    real = cli.device_prefetch

    def spy(batches, put, depth=2):
        prefetched.append((put, depth))
        for b in real(batches, put, depth):
            fed.append(b)
            yield b

    monkeypatch.setattr(cli, "device_prefetch", spy)
    res = cli.main([
        "pretrain", "--config", tiny_config, "--device", "cpu",
        "--meta", str(meta), "--data", str(data), "--neg_param", "60",
        "--num_workers", "2", "--set", "global_batch_size=8",
    ] + (["--device_norm"] if device_norm else []))
    assert len(res["logged"]) == 2 and _finite(res["logged"])
    assert prefetched == [(tloader.device_put(torch.device("cpu")), 2)]
    assert all(isinstance(b, tloader.DeviceBatch) for b in fed)
    assert [b["video"].shape[0] for b in fed] == [8, 8]
    assert {b["video"].dtype for b in fed} == {
        torch.uint8 if device_norm else torch.float32}
    assert all(b["text_ids"].dtype == torch.int64 for b in fed)


def test_pretrain_multi_dataset_round_robin(tiny_config, tmp_path):
    """A comma list of --meta trains round robin across the datasets, a
    batch of each in turn (BaseMultiDataLoader, base_data_loader.py:142):
    two files of 4 rows at a loader batch of 4 are two steps."""
    data, rows, _ = _egoclip(tmp_path)
    header, body = rows[0], rows[1:]
    meta_a, meta_b = tmp_path / "ego_a.csv", tmp_path / "ego_b.csv"
    meta_a.write_text("\n".join([header] + body[: len(body) // 2]))
    meta_b.write_text("\n".join([header] + body[len(body) // 2:]))
    res = cli.main([
        "pretrain", "--config", tiny_config, "--device", "cpu",
        "--meta", f"{meta_a},{meta_b}", "--data", str(data),
        "--neg_param", "60", "--num_workers", "1",
        "--set", "global_batch_size=8",
    ])
    assert len(res["logged"]) == 2 and _finite(res["logged"])


def test_pretrain_on_files_caps_the_epoch_in_loader_rows(tiny_config,
                                                        tmp_path):
    """`max_samples_per_epoch` counts loader rows (trainer_egoclip.py:108):
    4 rows at a loader batch of 4 (scene negatives double the step's 8) is
    one step, where the epoch has two; without negatives a loader batch is
    the global batch (8 rows: one step)."""
    data, _, meta = _egoclip(tmp_path)
    base = ["pretrain", "--config", tiny_config, "--device", "cpu",
            "--meta", str(meta), "--data", str(data), "--num_workers", "1"]
    res = cli.main(base + ["--set", "global_batch_size=8",
                           "max_samples_per_epoch=4"])
    assert len(res["logged"]) == 1
    res = cli.main(base + ["--neg_param", "0", "--set",
                           "global_batch_size=8"])
    assert len(res["logged"]) == 1


def test_pretrain_step_from_mp4s_matches_jax(tmp_path, monkeypatch):
    """One pretrain step from generated mp4s: the port's pipeline (EgoClip
    dataset with scene negatives, threaded loader, `pretrain_post_fn`)
    collates the JAX pipeline's batch bit for bit, and from the same
    weights (`weights.state_dict_from_flax`) and the same mined ITM indices
    the port's step gives the JAX step's loss parts within 1e-4, f32,
    dropout 0 (the tolerance of `tests/test_torch_pretrain.py`)."""
    import jax
    import jax.numpy as jnp

    from egovlpv2_tpu.train import step as jstep
    from egovlpv2_torch.train import step as tstep
    from tests.test_torch_pretrain import (PARTS, _configs, _flax_params,
                                           _inject_indices, _torch_model)

    data, _, meta = _egoclip(tmp_path)
    jcfg, tcfg = _configs()
    v = tcfg.model.video
    kw = dict(num_frames=v.num_frames, input_res=v.img_size, neg_param=60,
              seed=4)
    tds = tdatasets.EgoClipDataset(str(meta), str(data), **kw)
    jds = jdatasets.EgoClipDataset(str(meta), str(data), **kw)
    vocab = tcfg.model.text.vocab_size
    tbatch = next(iter(tloader.DataLoader(
        tds, 3, sampler=tloader.HostShardSampler(len(tds), seed=0),
        num_workers=1, post_fn=tloader.pretrain_post_fn(
            Tokenizer(max_len=tcfg.max_text_len, vocab_cap=vocab),
            tcfg.mlm_prob)).epoch(0)))
    jbatch = next(iter(jloader.DataLoader(
        jds, 3, sampler=jloader.HostShardSampler(len(jds), seed=0),
        num_workers=1, post_fn=jloader.pretrain_post_fn(
            jloader.Tokenizer(max_len=jcfg.max_text_len, vocab_cap=vocab),
            jcfg.mlm_prob)).epoch(0)))
    assert set(tbatch) == set(jbatch)
    for key in tbatch:
        np.testing.assert_array_equal(tbatch[key], jbatch[key], err_msg=key)
    assert tbatch["video"].shape[0] == 6  # 3 rows and their negatives

    jmodel, params = _flax_params(jcfg, tbatch)
    _inject_indices(monkeypatch)
    _, ref = jstep.pretrain_loss_fn(
        params, {k: jnp.asarray(x) for k, x in jbatch.items()},
        jax.random.PRNGKey(2), model=jmodel, cfg=jcfg)
    model = _torch_model(tcfg, params)
    _, got = tstep.pretrain_loss_fn(
        model, tstep.batch_to_device(tbatch, torch.device("cpu")),
        torch.Generator().manual_seed(0), cfg=tcfg)
    for key in PARTS:
        np.testing.assert_allclose(got[key].item(), float(ref[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_train_loop_times_the_wait_for_the_batch(tiny_config):
    """A step is timed from its `next()` on the batch iterator to the end
    of its device work: a source that takes 0.3 s a batch shows in every
    step's time."""
    args = argparse.Namespace(epochs=1, log_every=1)

    def slow(_):
        for i in range(2):
            time.sleep(0.3)
            yield {"i": i}

    logged, seconds = cli._train_loop(args, torch.device("cpu"),
                                      lambda b: {"loss_total": 0.0}, slow)
    assert len(seconds) == 2 and min(seconds) >= 0.3
    assert [r["step"] for r in logged] == [1, 2]


def _charades_files(tmp_path, n=8):
    data = tmp_path / "char_videos"
    meta = tmp_path / "char_meta"
    meta.mkdir()
    train = ["id,narration,t_start,t_end"]
    val = ["id,actions"]
    for i in range(n):
        _write_mp4(data / f"CLIP{i}.mp4", seconds=1, seed=i)
        train.append(f"CLIP{i},person does thing {i},0.0,0.9")
        val.append(f"CLIP{i},c{i:03d} 0.0 1.0;c{(i * 7) % 157:03d} 0.1 0.5")
    (meta / "metadata_train.csv").write_text("\n".join(train))
    (meta / "metadata_val.csv").write_text("\n".join(val))
    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(f"class prompt {c}" for c in range(157)))
    return data, meta, classes


@pytest.mark.parametrize("device_norm", [False, True],
                         ids=["host_norm", "device_norm"])
def test_ft_charades_from_generated_mp4s(tiny_config, tmp_path,
                                         device_norm):
    """ft-charades over mp4s and metadata_train.csv (NormSoftmax; uint8
    frames normalised on the device with --device_norm): one step of 8."""
    data, meta, _ = _charades_files(tmp_path)
    res = cli.main([
        "ft-charades", "--config", tiny_config, "--device", "cpu",
        "--meta", str(meta), "--data", str(data),
        "--set", "global_batch_size=8",
    ] + (["--device_norm"] if device_norm else []))
    assert len(res["logged"]) == 1 and _finite(res["logged"])
    assert res["config"].model.video.uint8_norm == "imagenet"
    assert res["val"] == []


def test_ft_charades_validates_each_epoch(tiny_config, tmp_path):
    """--val_meta with --classes: after each epoch the 157 class prompts
    are scored against every val video (sliding windows pooled back to a
    row a video) and the mAP printed; without --classes it refuses."""
    data, meta, classes = _charades_files(tmp_path)
    base = ["ft-charades", "--config", tiny_config, "--device", "cpu",
            "--meta", str(meta), "--data", str(data), "--val_meta",
            str(meta), "--set", "global_batch_size=8"]
    res = cli.main(base + ["--epochs", "2", "--classes", str(classes),
                           "--val_batch_size", "3",
                           "--sliding_window_stride", "15"])
    assert len(res["val"]) == 2 and len(res["logged"]) == 2
    assert all(np.isfinite(list(m.values())).all() for m in res["val"])
    with pytest.raises(ValueError, match="--classes"):
        cli.main(base)


def _epic_files(tmp_path, n=8):
    rs = np.random.RandomState(7)
    data = tmp_path / "epic_frames"
    rows = []
    for i in range(n):
        pid, vid = "P01", f"P01_{i:02d}"
        d = data / pid / "rgb_frames" / vid
        d.mkdir(parents=True)
        for fidx in range(1, 31):
            cv2.imwrite(str(d / f"frame_{fidx:010d}.jpg"),
                        rs.randint(0, 255, (32, 32, 3), np.uint8))
        rows.append({"participant_id": pid, "video_id": vid,
                     "start_frame": 1, "stop_frame": 30,
                     "narration": f"cut thing {i}"})
    meta = tmp_path / "epic_meta"
    (meta / "relevancy").mkdir(parents=True)
    for tag in ("train", "test"):
        pd.DataFrame(rows).to_csv(meta / f"EPIC_100_retrieval_{tag}.csv",
                                  index=False)
        # every video and every caption with a relevant partner, as in
        # EK-100 (the official mAP divides by their count); the test split
        # has no sentence file, so its layout is square
        cols = 6 if tag == "train" else n
        rel = (rs.rand(n, cols) > 0.5).astype(np.float32) * rs.rand(n, cols)
        rel[np.arange(n), np.arange(n) % cols] = 1.0
        rel[np.arange(cols) % n, np.arange(cols)] = 1.0
        with open(meta / "relevancy" /
                  f"caption_relevancy_EPIC_100_retrieval_{tag}.pkl",
                  "wb") as f:
            pickle.dump(rel, f)
    pd.DataFrame({"narration": [f"sentence {j}" for j in range(6)]}).to_csv(
        meta / "EPIC_100_retrieval_train_sentence.csv", index=False)
    return data, meta


@pytest.mark.parametrize("device_norm", [False, True],
                         ids=["host_norm", "device_norm"])
def test_ft_epic_from_generated_frames(tiny_config, tmp_path, device_norm):
    """ft-epic over JPEG frame folders, the retrieval csv and its caption
    relevancy (AdaptiveMaxMargin with per-row weights; 0-255 regime, on the
    device with --device_norm), then the MIR validation over the test
    split: finite mAP and nDCG."""
    data, meta = _epic_files(tmp_path)
    res = cli.main([
        "ft-epic", "--config", tiny_config, "--device", "cpu",
        "--meta", str(meta), "--data", str(data), "--val_meta", str(meta),
        "--val_batch_size", "4", "--set", "global_batch_size=8",
    ] + (["--device_norm"] if device_norm else []))
    assert len(res["logged"]) == 1 and _finite(res["logged"])
    assert res["config"].model.video.uint8_norm == (
        "epic" if device_norm else "imagenet")
    (val,) = res["val"]
    assert val and all(np.isfinite(x) for x in val.values())


def _egomcq_files(tmp_path):
    data = tmp_path / "mcq_videos"
    for seed, uid in enumerate(("u0", "u1")):
        _write_mp4(data / uid / "0.mp4", seconds=2, seed=seed)
    meta = {}
    for q in range(3):
        meta[str(q)] = {
            "query": {"clip_text": f"does thing {q}"},
            "choices": {str(i): {"video_uid": ("u0", "u1")[i % 2],
                                 "clip_start": 0.1 + 0.3 * i,
                                 "clip_end": 0.6 + 0.3 * i}
                        for i in range(5)},
            "answer": q % 5,
            "types": 1 + q % 2,
        }
    path = tmp_path / "egomcq.json"
    path.write_text(json.dumps(meta))
    return data, path


@pytest.mark.parametrize("device_norm", [False, True],
                         ids=["host_norm", "device_norm"])
def test_egomcq_from_generated_mp4s(tiny_config, tmp_path, device_norm):
    """EgoMCQ over chunked videos and egomcq.json: 3 questions at batch 2
    are two steps (the last of one question), every score finite, the
    metrics written to --out; the scores equal the eval step's on the
    dataset's own items."""
    data, meta = _egomcq_files(tmp_path)
    out = tmp_path / "mcq_metrics.json"
    res = cli.main([
        "egomcq", "--config", tiny_config, "--device", "cpu",
        "--meta", str(meta), "--data", str(data), "--batch_size", "2",
        "--num_workers", "2", "--out", str(out),
    ] + (["--device_norm"] if device_norm else []))
    metrics = json.loads(out.read_text())
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert len(res["step_seconds"]) == 2
    assert res["scores"]["vtc"].shape == res["scores"]["vtm"].shape == (3, 5)
    ds = tdatasets.EgoMCQDataset(str(meta), str(data), num_frames=2,
                                 input_res=32, loading="lax",
                                 device_norm=device_norm)
    assert ds[0]["video5"].dtype == (np.uint8 if device_norm
                                     else np.float32)


def test_extract_from_mp4(tiny_config, tmp_path):
    """extract --videos: each file read whole at uniform frames, rounded
    back to uint8 and taken through the geometric eval transform; 20
    frames at 2 a window are 10 windows of projection_dim 64, saved as
    .npy and .pt, equal to the extractor's features on the frames of the
    JAX CLI's pipeline."""
    from egovlpv2_tpu.data import readers as jreaders
    from egovlpv2_tpu.data import transforms as jtransforms
    from egovlpv2_torch.tasks.extract import FeatureExtractor

    vid_dir = tmp_path / "vids"
    vid_dir.mkdir()
    w = cv2.VideoWriter(str(vid_dir / "clip0.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 30, (48, 48))
    assert w.isOpened()
    rs = np.random.RandomState(0)
    for _ in range(20):
        w.write(rs.randint(0, 255, (48, 48, 3), np.uint8))
    w.release()
    out = tmp_path / "feats"
    res = cli.main([
        "extract", "--config", tiny_config, "--device", "cpu",
        "--videos", str(vid_dir / "*.mp4"), "--out", str(out),
        "--inner_batch", "4", "--input_res", "32",
    ])
    feats = np.load(out / "clip0.npy")
    assert feats.shape == (10, 64) and (out / "clip0.pt").exists()
    np.testing.assert_array_equal(feats, res["features"]["clip0"])
    frames, _ = jreaders.read_frames_cv2(str(vid_dir / "clip0.mp4"), 20,
                                         sample="uniform")
    frames = jtransforms.eval_transform(
        np.round(frames * 255.0).astype(np.uint8), size=32, normalize=False)
    ex = FeatureExtractor(res["model"], inner_batch=4,
                          device_norm="imagenet")
    np.testing.assert_array_equal(feats, ex.clip_features(frames, 2))
    with pytest.raises(FileNotFoundError):
        cli.main(["extract", "--config", tiny_config, "--device", "cpu",
                  "--videos", str(tmp_path / "none" / "*.mp4"), "--out",
                  str(out)])


@pytest.mark.parametrize("argv", [
    ["extract", "--out", "o"],
    ["extract", "--out", "o", "--videos", "x.mp4", "--synthetic", "8"],
    ["pretrain"],
    ["ft-epic"],
])
def test_commands_need_files_or_synthetic(argv):
    """Each command on files needs its files or its synthetic switch, and
    says so; it never falls back to synthetic data."""
    with pytest.raises(ValueError, match="needs"):
        cli.main(argv + ["--device", "cpu"])
