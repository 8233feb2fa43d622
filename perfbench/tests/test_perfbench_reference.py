"""The plain reference against the program's own step on the CPU at tiny
widths in float32 (EgoVLPv2's two tasks, and the third architecture of
`tiny.py`): the same losses (dropout masks and ITM mining drawn alike),
first gradients and changes, within float32 rounding."""

import pytest

from perfbench import compare, harness, inputs


@pytest.mark.parametrize("cell", ["tiny_pretrain", "tiny_dual", "tiny_clip"])
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
    from perfbench.weights import init_kind, make_weights
    shapes = {"a.weight": (8, 4), "b.bias": (8,), "c.embeddings.weight":
              (5, 3), "video_model.cls_token": (1, 1, 4)}
    one = make_weights(shapes, 5, "cpu", init_kind)
    two = make_weights(shapes, 5, "cpu", init_kind)
    other = make_weights(shapes, 6, "cpu", init_kind)
    for n in shapes:
        assert one[n].equal(two[n])
    assert not one["a.weight"].equal(other["a.weight"])
    assert one["b.bias"].abs().sum() == 0
    assert one["video_model.cls_token"].abs().max() <= 0.04 + 1e-7


def test_a_tasks_own_weight_rules_and_a_fill():
    """`make_weights` takes a task's rules: a constant such as a logit
    scale's log(1 / 0.07), and a kind that no rule knows refused."""
    import math

    from perfbench.weights import init_kind, make_weights

    def rules(name, shape):
        return ("fill", math.log(1 / 0.07)) if name == "logit_scale" \
            else init_kind(name, shape)

    got = make_weights({"logit_scale": (), "a.weight": (8, 4)}, 5, "cpu",
                       rules)
    assert got["logit_scale"].shape == ()
    assert float(got["logit_scale"]) == pytest.approx(math.log(1 / 0.07))
    assert got["a.weight"].equal(make_weights({"a.weight": (8, 4)}, 5,
                                              "cpu", init_kind)["a.weight"])
    with pytest.raises(ValueError):
        make_weights({"x": (2,)}, 5, "cpu", lambda n, s: ("uniform", 1.0))


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
