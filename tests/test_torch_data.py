"""The port's data package (`egovlpv2_torch/data/`) against its originals in
`egovlpv2_tpu/data/` on the CPU: the same inputs, seeds and numpy draws give
the same arrays, bit for bit.

  * `loader.py`: `device_prefetch` (order, count, puts run ahead, an error
    re-raised at the consumer, an abandoned generator, `depth <= 0`
    inline, a `DeviceBatch` handed over on the consumer's thread), the
    device put on the CPU (`DevicePut`: `torch.as_tensor`, token ids and
    labels int64), `RoundRobinLoader` and `pretrain_post_fn` (scene
    negatives concatenated, MLM draws);
  * `transforms.py::train_transform_uint8`;
  * `native.py`, the binding of the repo's `native/libvideoproc.so`,
    against cv2 and against the JAX package's binding;
  * `readers.py`, every reader, on mp4s and JPEG folders OpenCV writes here;
  * `datasets.py`, every dataset's items, with and without `device_norm`;
  * `preprocess.py`, with ffmpeg monkeypatched.
"""

import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")

from egovlpv2_tpu.core import config as jconfig  # noqa: E402
from egovlpv2_tpu.data import datasets as jdatasets  # noqa: E402
from egovlpv2_tpu.data import loader as jloader  # noqa: E402
from egovlpv2_tpu.data import native as jnative  # noqa: E402
from egovlpv2_tpu.data import readers as jreaders  # noqa: E402
from egovlpv2_tpu.data import transforms as jtransforms  # noqa: E402
from egovlpv2_tpu.tasks import pretrain as jpretrain  # noqa: E402
from egovlpv2_torch.core import config as tconfig  # noqa: E402
from egovlpv2_torch.data import datasets as tdatasets  # noqa: E402
from egovlpv2_torch.data import loader as tloader  # noqa: E402
from egovlpv2_torch.data import native as tnative  # noqa: E402
from egovlpv2_torch.data import preprocess  # noqa: E402
from egovlpv2_torch.data import readers as treaders  # noqa: E402
from egovlpv2_torch.data import transforms as ttransforms  # noqa: E402
from egovlpv2_torch.data.tokenizer import Tokenizer  # noqa: E402
from egovlpv2_torch.tasks import pretrain as tpretrain  # noqa: E402
from tests.test_cli import _write_egoclip_fixture, _write_mp4  # noqa: E402

torch.set_num_threads(2)


def _same(a, b, what=""):
    """Two items (or batches) of the same keys, array for array, bit for
    bit; strings, numbers and lists equal."""
    assert set(a) == set(b), what
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype, key
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {key}")
        else:
            assert x == y, (what, key, x, y)


# ---------------------------------------------------------------- loader


def test_device_prefetch_orders_counts_and_raises():
    """`device_prefetch` as the JAX package's: the stream a sequential map
    gives, puts issued ahead of the consumer, an error of `put_fn` or of
    the source re-raised at the consumer, `depth=0` inline, and an
    abandoned generator releases its feeder."""
    put_log = []

    def put(b):
        put_log.append(b)
        return b * 10

    out = list(tloader.device_prefetch(iter(range(6)), put, depth=2))
    assert out == [0, 10, 20, 30, 40, 50] == list(
        jloader.device_prefetch(iter(range(6)), lambda b: b * 10, depth=2))
    assert put_log == list(range(6))

    # the puts run ahead: after one pull the feeder has put at least depth
    # more
    put_log.clear()
    gen = tloader.device_prefetch(iter(range(6)), put, depth=2)
    assert next(gen) == 0
    for _ in range(50):
        if len(put_log) >= 3:
            break
        time.sleep(0.02)
    assert len(put_log) >= 3
    gen.close()  # abandoned: the feeder stops

    put_log.clear()
    gen0 = tloader.device_prefetch(iter(range(3)), put, depth=0)
    assert next(gen0) == 0 and put_log == [0]  # inline

    def bad(b):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(tloader.device_prefetch(iter(range(2)), bad, depth=2))

    def source():
        yield 1
        raise KeyError("source")

    gen = tloader.device_prefetch(source(), put, depth=2)
    assert next(gen) == 10
    with pytest.raises(KeyError, match="source"):
        next(gen)


def test_abandoned_prefetch_stops_its_feeder():
    """Closing the generator stops the feeder thread: it puts no more
    batches than the queue, the one it holds and the one handed over."""
    puts = []
    before = threading.active_count()
    gen = tloader.device_prefetch(iter(range(100)),
                                  lambda b: puts.append(b) or b, depth=2)
    assert next(gen) == 0
    time.sleep(0.3)
    gen.close()
    time.sleep(0.5)  # the feeder polls its stop flag every 0.2 s
    assert len(puts) <= 2 + 2
    assert threading.active_count() <= before


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_hands_over_on_the_consumers_thread(depth):
    """A `DeviceBatch` is waited for on the consumer's thread when it is
    handed over (a wait issued in the feeder would order nothing for the
    consumer's stream), once, before the consumer sees it."""
    waits = []

    class Recorded(tloader.DeviceBatch):
        def wait(self):
            waits.append((self["i"], threading.get_ident()))
            return self

    def put(i):
        b = Recorded(i=i)
        b.put_on = threading.get_ident()
        return b

    consumer = threading.get_ident()
    seen = []
    for b in tloader.device_prefetch(iter(range(4)), put, depth=depth):
        seen.append(b["i"])
        assert waits[-1] == (b["i"], consumer)  # before the consumer has it
        assert (b.put_on == consumer) == (depth == 0)
    assert seen == [0, 1, 2, 3] and len(waits) == 4


def test_device_put_on_the_cpu():
    """On the CPU the put is `torch.as_tensor`: no stream, no pinning, the
    arrays' own types, token ids and labels as int64 (`text_mask` not);
    `batch_to_device` takes a `DeviceBatch` as it is."""
    from egovlpv2_torch.train.step import batch_to_device

    put = tloader.device_put("cpu")
    assert put is tloader.device_put("cpu") and put.copy_stream is None
    rs = np.random.RandomState(0)
    batch = {"video": rs.rand(2, 3, 4).astype(np.float32)[:, ::-1],
             "text_ids": rs.randint(0, 9, (2, 5)).astype(np.int32),
             "text_mask": np.ones((2, 5), np.int32),
             "text_mlm_labels": np.full((2, 5), -100, np.int32),
             "relevancy": np.ones(2), "idx": np.arange(2)}
    out = put(batch)
    assert isinstance(out, tloader.DeviceBatch) and out.ready is None
    assert out.wait() is out
    for key, value in batch.items():
        t = out[key]
        assert t.device.type == "cpu" and t.is_contiguous()
        want = np.int64 if key in ("text_ids", "text_mlm_labels") \
            else value.dtype
        assert t.numpy().dtype == want, key
        np.testing.assert_array_equal(t.numpy(), value)
        assert not t.is_pinned()
    assert batch_to_device(out, torch.device("cpu")) is out
    again = batch_to_device(batch, torch.device("cpu"))
    assert all(torch.equal(again[k], out[k]) for k in batch)


def test_round_robin_loader_alternates_and_drains():
    """BaseMultiDataLoader parity (base_data_loader.py:142): batches
    alternate across loaders a step, every loader drains, as the JAX
    package's."""

    class Fake:
        def __init__(self, tag, n):
            self.tag, self.n = tag, n

        def __len__(self):
            return self.n

        def epoch(self, epoch=0):
            for i in range(self.n):
                yield {"tag": self.tag, "i": i}

    fakes = [Fake("a", 3), Fake("b", 1), Fake("c", 2)]
    rr = tloader.RoundRobinLoader(fakes)
    out = list(rr.epoch(0))
    assert len(out) == len(rr) == 6
    assert [b["tag"] for b in out[:3]] == ["a", "b", "c"]
    assert [b["i"] for b in out if b["tag"] == "a"] == [0, 1, 2]
    assert out == list(jloader.RoundRobinLoader(fakes).epoch(0))


@pytest.mark.parametrize("negatives", [False, True])
def test_pretrain_post_fn_matches_jax(negatives):
    """The tokenized, MLM-masked batch (scene negatives concatenated along
    the batch) is the JAX package's, array for array, over three batches
    of one post function (its generator runs on)."""
    rs = np.random.RandomState(1)

    def batch(i):
        b = {"video": rs.rand(2, 2, 4, 4, 3).astype(np.float32),
             "text": [f"take the thing {i}", f"put it down now {i}"],
             "noun_vec": rs.rand(2, 582).astype(np.float32),
             "verb_vec": rs.rand(2, 118).astype(np.float32)}
        if negatives:
            b.update(video_neg=rs.rand(2, 2, 4, 4, 3).astype(np.float32),
                     text_neg=["open the door", "close it"],
                     noun_vec_neg=rs.rand(2, 582).astype(np.float32),
                     verb_vec_neg=rs.rand(2, 118).astype(np.float32))
        return b

    tpost = tloader.pretrain_post_fn(Tokenizer(max_len=12, vocab_cap=256),
                                     0.4, seed=3)
    jpost = jloader.pretrain_post_fn(
        jloader.Tokenizer(max_len=12, vocab_cap=256), 0.4, seed=3)
    for i in range(3):
        b = batch(i)
        got = tpost({k: (list(v) if isinstance(v, list) else v.copy())
                     for k, v in b.items()})
        _same(got, jpost(b), f"batch {i}")
        assert got["video"].shape[0] == (4 if negatives else 2)
        assert got["text_mlm_ids"].max() < 256


# ------------------------------------------------------------ transforms


def test_train_transform_uint8_roundtrip():
    """The uint8 geometric output is the f32 pipeline's up to 8-bit
    quantization (the same generator: the same crop and flip), and the JAX
    package's bit for bit."""
    rs = np.random.RandomState(5)
    clip = rs.rand(3, 40, 40, 3).astype(np.float32)
    f = ttransforms.train_transform(clip, np.random.default_rng(9), size=32,
                                    normalize=False)
    u = ttransforms.train_transform_uint8(clip, np.random.default_rng(9),
                                          size=32)
    assert u.dtype == np.uint8
    np.testing.assert_allclose(u.astype(np.float32) / 255.0, f,
                               atol=1 / 255.0)
    np.testing.assert_array_equal(u, jtransforms.train_transform_uint8(
        clip, np.random.default_rng(9), size=32))
    np.testing.assert_array_equal(ttransforms.EPIC_MEAN,
                                  jtransforms.EPIC_MEAN)
    np.testing.assert_array_equal(ttransforms.EPIC_STD, jtransforms.EPIC_STD)


@pytest.mark.parametrize("normalize", [True, False])
def test_transforms_match_jax_bit_for_bit(normalize):
    """The train and eval transforms (the normalisation through the C++
    kernel where it is built, as the JAX package's) give the same arrays
    from the same generator, imagenet and EPIC regimes."""
    rs = np.random.RandomState(6)
    clip = rs.rand(2, 45, 60, 3).astype(np.float32)
    for mean, std, scale in ((ttransforms.IMAGENET_MEAN,
                              ttransforms.IMAGENET_STD, 1.0),
                             (ttransforms.EPIC_MEAN, ttransforms.EPIC_STD,
                              255.0)):
        x = clip * scale
        kw = dict(size=32, mean=mean, std=std, normalize=normalize)
        np.testing.assert_array_equal(
            ttransforms.train_transform(x, np.random.default_rng(2), **kw),
            jtransforms.train_transform(x, np.random.default_rng(2), **kw))
        np.testing.assert_array_equal(ttransforms.eval_transform(x, **kw),
                                      jtransforms.eval_transform(x, **kw))
    assert np.array_equal(clip, rs.__class__(6).rand(2, 45, 60, 3)
                          .astype(np.float32))  # the input is not mutated


# ---------------------------------------------------------------- native


def _native():
    if not tnative.available():
        pytest.skip("native/libvideoproc.so is not built and cannot be "
                    "(make -C native needs make and g++)")
    assert jnative.available()


def test_native_finds_the_repos_library():
    """The port's binding loads the repo's `native/libvideoproc.so`, the
    library the JAX package's binding loads."""
    _native()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tnative._find_lib() == jnative._find_lib() == os.path.join(
        root, "native", "libvideoproc.so")


def test_native_resize_matches_cv2():
    _native()
    rs = np.random.RandomState(0)
    clip = rs.randint(0, 256, (3, 37, 53, 3), np.uint8)
    got = tnative.resize_bilinear(clip, 24, 32)
    ref = ttransforms._resize_clip(clip.astype(np.float32), (24, 32))
    np.testing.assert_allclose(got, ref, atol=0.51)  # cv2's fixed point
    np.testing.assert_array_equal(got, jnative.resize_bilinear(clip, 24, 32))


def test_native_resize_f32_matches_cv2():
    _native()
    rs = np.random.RandomState(1)
    clip = rs.rand(2, 40, 60, 3).astype(np.float32)
    got = tnative.resize_bilinear(clip, 17, 23)
    ref = ttransforms._resize_clip(clip, (17, 23))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got, jnative.resize_bilinear(clip, 17, 23))


def test_native_fused_crop_resize_normalize():
    _native()
    rs = np.random.RandomState(2)
    clip = rs.randint(0, 256, (2, 50, 70, 3), np.uint8)
    mean, std = ttransforms.IMAGENET_MEAN, ttransforms.IMAGENET_STD
    args = (clip, 5, 7, 40, 56, 32, False, mean, std)
    got = tnative.crop_resize_normalize(*args)
    # crop -> /255 -> resize -> normalize
    ref = ttransforms._resize_clip(
        clip[:, 5:45, 7:63].astype(np.float32) / 255.0, (32, 32))
    np.testing.assert_allclose(got, (ref - mean) / std, atol=0.02)
    np.testing.assert_array_equal(got, jnative.crop_resize_normalize(*args))


def test_native_fused_hflip():
    _native()
    rs = np.random.RandomState(3)
    clip = rs.randint(0, 256, (1, 32, 32, 3), np.uint8)
    mean, std = np.zeros(3, np.float32), np.ones(3, np.float32)
    plain = tnative.crop_resize_normalize(clip, 0, 0, 32, 32, 32, False,
                                          mean, std)
    flipped = tnative.crop_resize_normalize(clip, 0, 0, 32, 32, 32, True,
                                            mean, std)
    np.testing.assert_allclose(flipped, plain[:, :, ::-1], atol=1e-5)


def test_native_normalize_inplace():
    _native()
    rs = np.random.RandomState(4)
    clip = rs.rand(2, 8, 8, 3).astype(np.float32)
    ref = (clip - ttransforms.IMAGENET_MEAN) / ttransforms.IMAGENET_STD
    got = tnative.normalize_inplace(clip.copy(), ttransforms.IMAGENET_MEAN,
                                    ttransforms.IMAGENET_STD)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_array_equal(got, jnative.normalize_inplace(
        clip.copy(), ttransforms.IMAGENET_MEAN, ttransforms.IMAGENET_STD))


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every dataset's files, written once: EgoClip chunks (a clip of vid_a
    spans its chunks 0 and 1), EgoMCQ's json, EK-100 frame folders and
    csv files (train with caption relevancy, test), Charades-Ego videos
    and metadata (train windows, val actions), and a webm-free mp4."""
    root = tmp_path_factory.mktemp("data")
    data, rows = _write_egoclip_fixture(root)
    _write_mp4(data / "vid_a" / "1.mp4", seconds=1, seed=5)
    rows.append("vid_a\t599.8\t599.6\t600.4\tspan the chunks\t[7]\t[2]")
    (root / "egoclip.csv").write_text("\n".join(rows))

    mcq = {}
    for q in range(3):
        mcq[str(q)] = {
            "query": {"clip_text": f"does thing {q}"},
            "choices": {str(i): {"video_uid": ("vid_a", "vid_b")[i % 2],
                                 "clip_start": 0.1 + 0.3 * i,
                                 "clip_end": 0.6 + 0.3 * i}
                        for i in range(5)},
            "answer": q % 5, "types": 1 + q % 2}
    (root / "egomcq.json").write_text(json.dumps(mcq))

    rs = np.random.RandomState(7)
    epic = root / "epic_frames"
    meta = root / "epic_meta"
    (meta / "relevancy").mkdir(parents=True)
    rows = []
    for i in range(4):
        pid, vid = "P01", f"P01_{i:02d}"
        d = epic / pid / "rgb_frames" / vid
        d.mkdir(parents=True)
        for fidx in range(1, 41):
            cv2.imwrite(str(d / f"frame_{fidx:010d}.jpg"),
                        rs.randint(0, 255, (36, 40, 3), np.uint8))
        rows.append({"participant_id": pid, "video_id": vid,
                     "start_frame": 1 + i, "stop_frame": 30 + i,
                     "narration": f"cut thing {i}"})
    for tag in ("train", "test"):
        pd.DataFrame(rows).to_csv(meta / f"EPIC_100_retrieval_{tag}.csv",
                                  index=False)
    rel = (rs.rand(4, 6) > 0.5).astype(np.float32) * rs.rand(4, 6)
    with open(meta / "relevancy" /
              "caption_relevancy_EPIC_100_retrieval_train.pkl", "wb") as f:
        pickle.dump(rel, f)
    pd.DataFrame({"narration": [f"sentence {j}" for j in range(6)]}).to_csv(
        meta / "EPIC_100_retrieval_train_sentence.csv", index=False)

    char = root / "char_videos"
    cmeta = root / "char_meta"
    cmeta.mkdir()
    train = ["id,narration,t_start,t_end"]
    val = ["id,actions"]
    for i in range(3):
        _write_mp4(char / f"CLIP{i}EGO.mp4", seconds=1, res=40, seed=i)
        train.append(f"CLIP{i}EGO,person does thing {i},0.1,0.8")
        val.append(f"CLIP{i}EGO,c{i:03d} 0.0 1.0;c{i + 10:03d} 0.1 0.5")
    (cmeta / "metadata_train.csv").write_text("\n".join(train))
    (cmeta / "metadata_val.csv").write_text("\n".join(val))
    return root


# --------------------------------------------------------------- readers


def test_cv2_readers_match_jax(files):
    """`read_frames_cv2`, `read_frames_cv2_egoclip` (within a chunk and
    across two chunk files), `read_frames_cv2_epic` and
    `read_frames_cv2_charades` (whole video, and a window in seconds): the
    JAX package's frames and indices from the same generator draws."""
    d = files / "videos"
    a0, a1 = str(d / "vid_a" / "0.mp4"), str(d / "vid_a" / "1.mp4")
    epic = str(files / "epic_frames" / "P01" / "rgb_frames" / "P01_01")
    char = str(files / "char_videos" / "CLIP1EGO.mp4")
    calls = [
        ("read_frames_cv2", (a0, 4), dict(sample="rand")),
        ("read_frames_cv2", (a0, 5), dict(sample="uniform")),
        ("read_frames_cv2_egoclip", (a0, a0, 4, "rand", 0.2, 0.9, 600), {}),
        ("read_frames_cv2_egoclip", (a0, a1, 4, "uniform", 599.6, 600.4,
                                     600), {}),
        ("read_frames_cv2_epic", (epic, 3, 30, 4), dict(sample="rand")),
        ("read_frames_cv2_epic", (epic, 3, 30, 4), dict(sample="uniform",
                                                          fix_start=2)),
        ("read_frames_cv2_charades", (char, 3, "rand"), {}),
        ("read_frames_cv2_charades", (char, 3, "uniform"),
         dict(start_sec=0.1, end_sec=0.8)),
    ]
    for name, args, kw in calls:
        got = getattr(treaders, name)(*args, rng=np.random.default_rng(4),
                                      **kw)
        want = getattr(jreaders, name)(*args, rng=np.random.default_rng(4),
                                       **kw)
        assert got[0].dtype == np.float32 and got[0].ndim == 4, name
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        assert list(got[1]) == list(want[1]), name
    assert treaders.get_video_len(a0) == jreaders.get_video_len(a0) == 90
    assert treaders.get_video_len(str(files / "missing.mp4")) == 0
    assert set(treaders.VIDEO_READERS) == set(jreaders.VIDEO_READERS)
    with pytest.raises(FileNotFoundError):
        treaders.read_frames_cv2_charades(str(files / "missing.mp4"), 2,
                                          "uniform")


@pytest.mark.parametrize("name, module", [
    ("read_frames_av", "av"), ("read_frames_decord", "decord"),
    ("read_frames_decord_start_end", "decord")])
def test_optional_readers_import_their_library_in_the_call(files, name,
                                                           module):
    """The PyAV and decord readers import their library inside the call:
    the module imports without it, and the call then raises
    ModuleNotFoundError; where the library is installed they give the JAX
    package's frames."""
    path = str(files / "videos" / "vid_b" / "0.mp4")
    args = (path, 4) if name != "read_frames_decord_start_end" \
        else (path, 3, 40, 4)
    try:
        __import__(module)
    except ImportError:
        with pytest.raises(ModuleNotFoundError, match=module):
            getattr(treaders, name)(*args)
        return
    got = getattr(treaders, name)(*args)
    want = getattr(jreaders, name)(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])


# -------------------------------------------------------------- datasets


def _tiny_configs():
    return jpretrain.tiny_train_config(), tpretrain.tiny_train_config()


def _pair(kind, files, device_norm):
    """(JAX dataset, port dataset) of `kind` on the files, same seed."""
    data = str(files / "videos")
    if kind.startswith("egoclip"):
        neg = 60 if kind == "egoclip_neg" else None
        kw = dict(num_frames=2, input_res=32, neg_param=neg, seed=3,
                  device_norm=device_norm)
        meta = str(files / "egoclip.csv")
        return (jdatasets.EgoClipDataset(meta, data, **kw),
                tdatasets.EgoClipDataset(meta, data, **kw))
    if kind == "egomcq":
        kw = dict(num_frames=3, input_res=32, device_norm=device_norm)
        meta = str(files / "egomcq.json")
        return (jdatasets.EgoMCQDataset(meta, data, **kw),
                tdatasets.EgoMCQDataset(meta, data, **kw))
    if kind.startswith("epic"):
        split, stride = (("train", -1) if kind == "epic_train"
                         else ("test", 8))
        kw = dict(split=split, num_frames=4, input_res=32, seed=5,
                  sliding_window_stride=stride, device_norm=device_norm)
        args = (str(files / "epic_meta"), str(files / "epic_frames"))
        return (jdatasets.EpicKitchensMIRDataset(*args, **kw),
                tdatasets.EpicKitchensMIRDataset(*args, **kw))
    if kind.startswith("charades"):
        split, stride = (("train", -1) if kind == "charades_train"
                         else ("val", 10))
        kw = dict(split=split, num_frames=3, input_res=32, seed=6,
                  sliding_window_stride=stride, device_norm=device_norm)
        args = (str(files / "char_meta"), str(files / "char_videos"))
        return (jdatasets.CharadesEgoDataset(*args, **kw),
                tdatasets.CharadesEgoDataset(*args, **kw))
    jcfg, tcfg = _tiny_configs()
    return (jdatasets.SyntheticVideoTextDataset(jcfg, length=3, seed=2),
            tdatasets.SyntheticVideoTextDataset(tcfg, length=3, seed=2))


# (dataset, device_norm): EgoClip with and without scene negatives, EgoMCQ,
# EK-100 train (relevancy-sampled captions) and test (sliding windows),
# Charades-Ego train (windows in seconds) and val (157-way targets, sliding
# windows), each with and without uint8 out; the synthetic dataset has no
# `device_norm` in the JAX package
DATASET_CASES = [(kind, dn) for kind in (
    "egoclip_neg", "egoclip", "egomcq", "epic_train", "epic_test",
    "charades_train", "charades_val") for dn in (False, True)] \
    + [("synthetic", False)]


@pytest.mark.parametrize("kind, device_norm", DATASET_CASES)
def test_dataset_items_match_jax(files, kind, device_norm):
    """Every item of the port's dataset, in order, is the JAX dataset's:
    the same keys, arrays bit for bit (video uint8 where `device_norm`
    asks for it on a training split, EgoMCQ too), captions, targets and
    indices equal; and the two lengths equal."""
    jds, tds = _pair(kind, files, device_norm)
    assert len(tds) == len(jds) > 0
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        _same(got, want, f"{kind} item {i}")
    video = got.get("video", got.get("video5"))
    uint8 = device_norm and kind in ("egoclip_neg", "egoclip", "egomcq",
                                     "epic_train", "charades_train")
    assert video.dtype == (np.uint8 if uint8 else np.float32)
    if kind == "egoclip_neg":
        assert {"video_neg", "text_neg", "noun_vec_neg"} <= set(got)


def test_loader_batches_of_egoclip_match_jax(files):
    """The threaded loader (one worker: items in order), the collate and
    `pretrain_post_fn` over the EgoClip files with scene negatives give the
    JAX package's batches, array for array."""
    jds, tds = _pair("egoclip_neg", files, True)
    jtok = jloader.Tokenizer(max_len=12, vocab_cap=256)
    tbatches = list(tloader.DataLoader(
        tds, 3, sampler=tloader.HostShardSampler(len(tds), seed=1),
        num_workers=1, post_fn=tloader.pretrain_post_fn(
            Tokenizer(max_len=12, vocab_cap=256))).epoch(0))
    jbatches = list(jloader.DataLoader(
        jds, 3, sampler=jloader.HostShardSampler(len(jds), seed=1),
        num_workers=1, post_fn=jloader.pretrain_post_fn(jtok)).epoch(0))
    assert len(tbatches) == len(jbatches) == 3
    for i, (got, want) in enumerate(zip(tbatches, jbatches)):
        _same(got, want, f"batch {i}")
        assert got["video"].shape == (6, 2, 32, 32, 3)


def test_datasets_import_pandas_and_cv2_inside_calls():
    """The module imports no video or table library at import time (the
    card's machine has none of them)."""
    import subprocess
    import sys

    code = ("import sys; import egovlpv2_torch.data.datasets, "
            "egovlpv2_torch.data.readers, egovlpv2_torch.data.preprocess, "
            "egovlpv2_torch.data.native, egovlpv2_torch.data.loader; "
            "print(sorted(m for m in ('cv2', 'av', 'decord', 'pandas') "
            "if m in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


# ------------------------------------------------------------ preprocess


def test_resize_video_command(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(preprocess.subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    ok = preprocess.resize_video(str(tmp_path / "in.mp4"),
                                 str(tmp_path / "out" / "v.mp4"), height=256)
    assert ok and len(calls) == 1
    cmd = calls[0]
    # video_resize.py:17-31: scale to height, even width, copy audio
    assert cmd[0] == "ffmpeg" and "-filter:v" in cmd
    assert cmd[cmd.index("-filter:v") + 1] == "scale=trunc(oh*a/2)*2:256"
    assert cmd[cmd.index("-c:a") + 1] == "copy"
    assert os.path.isdir(tmp_path / "out")  # parent created


def test_resize_video_skips_existing(tmp_path, monkeypatch):
    out = tmp_path / "done.mp4"
    out.write_bytes(b"x")
    monkeypatch.setattr(preprocess.subprocess, "call",
                        lambda *a, **k: pytest.fail("must not re-encode"))
    assert preprocess.resize_video(str(tmp_path / "in.mp4"), str(out))


def test_chunk_video_short_copies_single_chunk(tmp_path):
    src = tmp_path / "v.mp4"
    _write_mp4(src, seconds=2)
    n = preprocess.chunk_video(str(src), str(tmp_path / "chunks"), "uid1",
                               dur_limit=600)
    assert n == 1
    assert (tmp_path / "chunks" / "uid1" / "0.mp4").exists()


def test_chunk_video_long_splits_at_limit(tmp_path, monkeypatch):
    src = tmp_path / "long.mp4"
    _write_mp4(src, seconds=5)
    calls = []
    monkeypatch.setattr(preprocess.subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    n = preprocess.chunk_video(str(src), str(tmp_path / "chunks"), "uid2",
                               dur_limit=2.0)
    # video_chunk.py:27-67: floor(5/2)+1 = 3 chunks over [0,2],[2,4],[4,5]
    assert n == 3 and len(calls) == 3
    spans = [(float(c[c.index("-ss") + 1]), float(c[c.index("-to") + 1]))
             for c in calls]
    assert spans[0] == (0.0, 2.0) and spans[1] == (2.0, 4.0)
    assert spans[2][0] == 4.0 and 4.9 <= spans[2][1] <= 5.1
    assert [os.path.basename(c[-1]) for c in calls] == \
        ["0.mp4", "1.mp4", "2.mp4"]


def test_write_charades_meta_keeps_egocentric_rows(tmp_path):
    """`write_charades_meta` writes the JAX package's csv, byte for byte;
    `ffmpeg_available` probes the PATH and requires nothing."""
    from egovlpv2_tpu.data import preprocess as jpreprocess

    anns = [{"id": "AB12EGO", "script": "opens a door", "actions":
             "c001 0.0 2.0", "t_start": 0.0, "t_end": 2.0},
            {"id": "AB12", "script": "third person"},
            {"id": "CD34EGO", "narration": "sits"}]
    for mod, name in ((preprocess, "t.csv"), (jpreprocess, "j.csv")):
        mod.write_charades_meta(anns, str(tmp_path / "m" / name))
    text = (tmp_path / "m" / "t.csv").read_text()
    assert text == (tmp_path / "m" / "j.csv").read_text()
    assert "AB12EGO" in text and "CD34EGO" in text and "AB12," not in text
    assert preprocess.ffmpeg_available() == jpreprocess.ffmpeg_available()


def test_config_dataclasses_agree():
    """The tiny configs the synthetic dataset draws from are the same in
    both packages (so its items can be compared)."""
    import dataclasses

    jcfg, tcfg = _tiny_configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jconfig.NORM_STATS == tconfig.NORM_STATS
