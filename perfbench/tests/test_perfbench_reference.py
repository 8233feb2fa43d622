"""The plain reference against the port's own step on the CPU at tiny
widths in float32: the same losses (dropout masks and ITM mining drawn
alike), first gradients and changes, within float32 rounding."""

import pytest

from perfbench import compare, harness, inputs


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_reference_follows_the_port_in_float32(tiny_root_f32, cell, seed):
    c = harness.Cell(tiny_root_f32, cell)
    seeds = harness.Seeds(seed)
    pool = inputs.make_pool(c.cfg, c.traffic, c.rows, seeds.data, "cpu")
    prog = harness.Program(c, seeds, "cpu")
    got = prog.checked_steps(harness.device_batches(pool, "cpu"), 3)
    ref = harness.reference_readings(c, seeds, prog.shapes, pool, 3, "cpu")
    for mine, theirs in zip(got["losses"], ref["losses"]):
        assert mine == pytest.approx(theirs, rel=1e-5)
    gaps = compare.gaps(got, ref)
    assert max(v for k, v in gaps.items() if k.startswith("loss")) < 1e-5
    assert gaps["grad_gap"] < 1e-3
    assert gaps["delta_gap"] < 1e-3


def test_seeded_weights_repeat_and_differ():
    from perfbench.weights import make_weights
    shapes = {"a.weight": (8, 4), "b.bias": (8,), "c.embeddings.weight":
              (5, 3), "video_model.cls_token": (1, 1, 4)}
    one = make_weights(shapes, 5, "cpu")
    two = make_weights(shapes, 5, "cpu")
    other = make_weights(shapes, 6, "cpu")
    for n in shapes:
        assert one[n].equal(two[n])
    assert not one["a.weight"].equal(other["a.weight"])
    assert one["b.bias"].abs().sum() == 0
    assert one["video_model.cls_token"].abs().max() <= 0.04 + 1e-7


def test_pool_batches_differ_and_repeat():
    cfg = {"model": {"video": {"num_frames": 2, "img_size": 32,
                               "in_chans": 3},
                     "text": {"vocab_size": 256}},
           "max_text_len": 12, "mlm_prob": 0.15}
    traffic = {"pool_batches": 3, "parts": ["video", "text", "mlm"],
               "text_len_min": 4}
    a = inputs.make_pool(cfg, traffic, 8, 2 ** 31 + 5, "cpu")
    b = inputs.make_pool(cfg, traffic, 8, 2 ** 31 + 5, "cpu")
    assert all(x[k].equal(y[k]) for x, y in zip(a, b) for k in x)
    assert not a[0]["video"].equal(a[1]["video"])
    lens = a[0]["text_mask"].sum(1)
    assert lens.min() >= 4 and lens.max() <= 12
    ids = a[0]["text_ids"]
    assert (ids[:, 0] == inputs.BOS).all()
    assert (ids[range(8), lens - 1] == inputs.EOS).all()
    labels = a[0]["text_mlm_labels"]
    assert ((labels == -100) | (labels == ids)).all()
