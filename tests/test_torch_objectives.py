"""egovlpv2_torch.objectives against egovlpv2_tpu.objectives on the CPU, f32:
every loss, value and gradient, and the ITM mining (its parts without
randomness against JAX given JAX's own draws; its distribution alone).

Tolerance 1e-5: a few hundred f32 operations on each side."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from egovlpv2_tpu.models.egovlp import sim_matrix as jsim_matrix
from egovlpv2_tpu.objectives import itm_mining as jmine
from egovlpv2_tpu.objectives import losses as jloss
from egovlpv2_torch.models.egovlp import sim_matrix as tsim_matrix
from egovlpv2_torch.objectives import itm_mining as tmine
from egovlpv2_torch.objectives import losses as tloss

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _sims(seed, b=8):
    rs = np.random.RandomState(seed)
    t, v = rs.randn(b, 16).astype(np.float32), rs.randn(b, 16).astype(np.float32)
    noun = (rs.rand(b, 12) < 0.3).astype(np.float32)
    verb = (rs.rand(b, 6) < 0.4).astype(np.float32)
    noun[:, 0] = 1  # no empty rows
    verb[:, 0] = 1
    return t, v, noun, verb


def _check(jfn, tfn, arrays, int_arrays=()):
    """Value and gradient w.r.t. each float array."""
    jargs = [jnp.asarray(a) for a in arrays] + [jnp.asarray(a) for a in int_arrays]
    ref, ref_grads = jax.value_and_grad(
        jfn, argnums=tuple(range(len(arrays))))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = tfn(*leaves, *(torch.from_numpy(a) for a in int_arrays))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    for leaf, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **TOL)


def test_sim_matrix_matches_jax():
    t, v, _, _ = _sims(0)
    _check(lambda a, b: jnp.sum(jsim_matrix(a, b) ** 2),
           lambda a, b: (tsim_matrix(a, b) ** 2).sum(), [t, v])
    t[1] = 0  # a zero row meets the eps clamp (value only: the norm has no
    # gradient at 0)
    np.testing.assert_allclose(
        tsim_matrix(torch.from_numpy(t), torch.from_numpy(v)).numpy(),
        np.asarray(jsim_matrix(jnp.asarray(t), jnp.asarray(v))), **TOL)


@pytest.mark.parametrize("noun, verb", [(True, True), (True, False),
                                        (False, True), (False, False)])
def test_egonce_loss_matches_jax(noun, verb):
    t, v, nv, vv = _sims(1)

    def jfn(t, v):
        sim = jsim_matrix(t, v)
        return jloss.egonce_loss(sim, jsim_matrix(jnp.asarray(vv), jnp.asarray(vv)),
                                 jsim_matrix(jnp.asarray(nv), jnp.asarray(nv)),
                                 0.05, noun, verb)[0]

    def tfn(t, v):
        sim = tsim_matrix(t, v)
        tv, tn = torch.from_numpy(vv), torch.from_numpy(nv)
        return tloss.egonce_loss(sim, tsim_matrix(tv, tv), tsim_matrix(tn, tn),
                                 0.05, noun, verb)[0]

    _check(jfn, tfn, [t, v])
    sim = jsim_matrix(jnp.asarray(t), jnp.asarray(v))
    _, jmask, jtemp = jloss.egonce_loss(
        sim, jsim_matrix(jnp.asarray(vv), jnp.asarray(vv)),
        jsim_matrix(jnp.asarray(nv), jnp.asarray(nv)), 0.07, noun, verb)
    tv, tn = torch.from_numpy(vv), torch.from_numpy(nv)
    _, tmask, ttemp = tloss.egonce_loss(
        torch.from_numpy(np.array(sim)), tsim_matrix(tv, tv),
        tsim_matrix(tn, tn), 0.07, noun, verb)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert ttemp == jtemp == 0.07 and tmask.dtype == torch.bool


def test_norm_softmax_loss_matches_jax():
    t, v, _, _ = _sims(2)
    _check(lambda a, b: jloss.norm_softmax_loss(jsim_matrix(a, b), 0.05),
           lambda a, b: tloss.norm_softmax_loss(tsim_matrix(a, b), 0.05), [t, v])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fix_norm", [True, False])
def test_max_margin_loss_matches_jax(fix_norm, weighted):
    rs = np.random.RandomState(3)
    sim = rs.randn(7, 7).astype(np.float32) * 0.3
    w = rs.rand(7).astype(np.float32)
    if weighted:
        _check(lambda s, w: jloss.max_margin_loss(s, 0.2, w, fix_norm),
               lambda s, w: tloss.max_margin_loss(s, 0.2, w, fix_norm), [sim, w])
    else:
        _check(lambda s: jloss.max_margin_loss(s, 0.2, None, fix_norm),
               lambda s: tloss.max_margin_loss(s, 0.2, None, fix_norm), [sim])


@pytest.mark.parametrize("any_valid", [True, False])
def test_masked_lm_loss_matches_jax(any_valid):
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 5, 11).astype(np.float32)
    labels = np.full((3, 5), -100, np.int32)
    if any_valid:
        labels[0, 1], labels[2, 3], labels[2, 4] = 4, 0, 10
    _check(jloss.masked_lm_loss, tloss.masked_lm_loss, [logits], [labels])


@pytest.mark.parametrize("name", ["itm_loss", "cross_entropy_loss"])
def test_classification_losses_match_jax(name):
    rs = np.random.RandomState(5)
    classes = 2 if name == "itm_loss" else 9
    logits = rs.randn(6, classes).astype(np.float32)
    labels = rs.randint(0, classes, 6).astype(np.int32)
    _check(getattr(jloss, name), getattr(tloss, name), [logits], [labels])


@pytest.mark.parametrize("b", [8, 7])
def test_mining_matches_jax_given_jax_draws(b):
    """JAX mines with its key; the port's `mining_weights` feed the same
    categorical draws and its `combine_indices` the same labels and coin:
    the indices must be JAX's."""
    t, v, nv, vv = _sims(6, b)
    sim = np.asarray(jsim_matrix(jnp.asarray(t), jnp.asarray(v)))
    mask = np.asarray(jsim_matrix(jnp.asarray(nv), jnp.asarray(nv))
                      * jsim_matrix(jnp.asarray(vv), jnp.asarray(vv))) \
        + np.eye(b, dtype=np.float32) > 0
    assert mask.sum() > b  # some extra positives to mask out
    key = jax.random.PRNGKey(7)
    ref = jmine.mine_itm_indices(key, jnp.asarray(sim), jnp.asarray(mask), 0.05)
    assert int(np.asarray(ref.labels).sum()) == b // 2

    r_perm, r_coin, r_t2v, r_v2t = jax.random.split(key, 4)
    w_t2v, w_v2t = tmine.mining_weights(torch.from_numpy(sim),
                                        torch.from_numpy(mask), 0.05)
    neg_video = jax.random.categorical(r_t2v, jnp.log(jnp.asarray(w_t2v.numpy()) + 1e-9), axis=-1)
    neg_text = jax.random.categorical(r_v2t, jnp.log(jnp.asarray(w_v2t.numpy()) + 1e-9), axis=-1)
    coin = jax.random.bernoulli(r_coin, 0.5, (b,))
    as_t = lambda a, dt=torch.long: torch.from_numpy(np.asarray(a)).to(dt)
    got = tmine.combine_indices(as_t(ref.labels), as_t(coin, torch.bool),
                                as_t(neg_video), as_t(neg_text))
    for field in ("video_idx", "text_idx", "labels"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_mining_draws_and_their_distribution():
    """The port's own draws: seeded; floor(B/2) positives keep their pair;
    a negative swaps exactly one side for a non-positive example; over many
    draws the swap follows the masked softmax row."""
    b = 6
    rs = np.random.RandomState(8)
    sim = torch.from_numpy(rs.rand(b, b).astype(np.float32) * 0.2)
    mask = torch.eye(b, dtype=torch.bool)
    mask[0, 1] = mask[1, 0] = True
    a = tmine.mine_itm_indices(torch.Generator().manual_seed(0), sim, mask, 0.05)
    again = tmine.mine_itm_indices(torch.Generator().manual_seed(0), sim, mask, 0.05)
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    w_t2v, w_v2t = tmine.mining_weights(sim, mask, 0.05)
    gen = torch.Generator().manual_seed(1)
    own = torch.arange(b)
    video_counts, text_counts = torch.zeros(b, b), torch.zeros(b, b)
    for _ in range(3000):
        idx = tmine.mine_itm_indices(gen, sim, mask, 0.05)
        assert int(idx.labels.sum()) == b // 2
        pos = idx.labels == 1
        assert torch.equal(idx.video_idx[pos], own[pos])
        assert torch.equal(idx.text_idx[pos], own[pos])
        swapped_v, swapped_t = idx.video_idx != own, idx.text_idx != own
        assert not (swapped_v & swapped_t).any() and (swapped_v | swapped_t)[~pos].all()
        assert not mask[own, idx.video_idx][swapped_v].any()
        assert not mask[own, idx.text_idx][swapped_t].any()
        video_counts[own[swapped_v], idx.video_idx[swapped_v]] += 1
        text_counts[own[swapped_t], idx.text_idx[swapped_t]] += 1
    for counts, w in ((video_counts, w_t2v), (text_counts, w_v2t)):
        assert counts.sum() > 3000  # about 3000 * 3 negatives * 1/2 each
        freq = counts / counts.sum(1, keepdim=True)
        want = w / w.sum(1, keepdim=True)
        # about 750 draws a row: 4 standard errors of a frequency near 0.25
        assert (freq - want).abs().max() < 0.07
