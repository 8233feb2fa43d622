"""The fused attention of egovlpv2_torch (`ops/flash.py`, `ops/attention.py`)
against egovlpv2_tpu on the CPU, float32, inputs from numpy seeds.

The JAX function reaches its Pallas kernel in interpret mode
(`pltpu.force_tpu_interpret_mode`) at lengths of 32 and above; below, the
JAX package hands the call to XLA, so the port is held against
`attend(impl="xla")` there. On CPU tensors the port takes the kernel's plain
version; the CUDA kernel itself is held against that version by the `gpu`
tests of `tests/test_torch_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from egovlpv2_tpu.ops import attention as jattn
from egovlpv2_tpu.ops import flash as jflash
from egovlpv2_torch.ops import _kernels, flash
from egovlpv2_torch.ops import attention as tattn

torch.set_num_threads(2)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _qkv(seed, qshape, sk):
    rs = np.random.RandomState(seed)
    kshape = qshape[:-2] + (sk, qshape[-1])
    return (rs.randn(*qshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32))


def _mask(seed, b, sk):
    mask = (np.random.RandomState(seed).rand(b, sk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return mask


def _jax_pallas(q, k, v, bias=None):
    with pltpu.force_tpu_interpret_mode():
        return jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale=q.shape[-1] ** -0.5, bias=bias,
                            impl="pallas")


@pytest.mark.parametrize("qshape, sk", [
    ((2, 3, 2, 37, 40), 37),  # many leading axes, odd lengths
    ((2, 2, 33, 64), 33),
    ((2, 2, 196, 64), 197),   # space attention with the CLS key
    ((2, 2, 33, 12), 35),     # a head dim that is not a multiple of 8
])
def test_flash_attention_matches_jax_pallas_forward(qshape, sk):
    q, k, v = _qkv(0, qshape, sk)
    ref = _jax_pallas(q, k, v)
    got = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                scale=qshape[-1] ** -0.5)
    assert got.shape == qshape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_flash_attention_with_padding_bias_matches_jax_pallas():
    b, h, sq, sk, dh = 2, 2, 33, 40, 8
    q, k, v = _qkv(1, (b, h, sq, dh), sk)
    mask = _mask(1, b, sk)
    jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                             (b, h, 1, sk))
    ref = _jax_pallas(q, k, v, bias=jbias)
    # the port takes the unexpanded [B, 1, 1, Sk] mask and the expanded one
    tbias = tattn.make_additive_mask(torch.from_numpy(mask))
    for bias in (tbias, tbias.expand(b, h, 1, sk)):
        got = tattn.attend(*(torch.from_numpy(x) for x in (q, k, v)),
                           scale=dh ** -0.5, bias=bias)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_gradients_match_jax_pallas(with_bias):
    b, h, sq, sk, dh = 2, 2, 40, 33, 8
    q, k, v = _qkv(2, (b, h, sq, dh), sk)
    mask = _mask(3, b, sk)
    jbias = tbias = None
    if with_bias:
        jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                                 (b, h, 1, sk))
        tbias = tattn.make_additive_mask(torch.from_numpy(mask))

    def loss(q, k, v):
        out = jattn.attend(q, k, v, scale=dh ** -0.5, bias=jbias,
                           impl="pallas")
        return jnp.sum(out * out)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention(*leaves, scale=dh ** -0.5, bias=tbias)
    (out * out).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   **GRAD_TOL)


@pytest.mark.parametrize("sq, sk, masked", [
    (15, 15, True),    # text self-attention at pretrain's 15 tokens
    (30, 30, True),    # and at the fine-tunes' 30
    (50, 15, True),    # i2t: video queries over the text keys
    (15, 50, False),   # t2i: text queries over the video keys, no mask
])
def test_attend_matches_jax_xla_at_short_lengths_and_strided_views(sq, sk,
                                                                  masked):
    """Below 32 tokens the JAX package runs XLA; the port runs the fused
    path at every length. q is a `split_heads` view of a [B, S, H*Dh]
    projection, k and v are slices of one packed [B, Sk, 2, H, Dh]
    projection, as the models hand them over; forward and gradients."""
    b, h, dh = 2, 3, 16
    rs = np.random.RandomState(sq + sk)
    qp = rs.randn(b, sq, h * dh).astype(np.float32)
    kvp = rs.randn(b, sk, 2, h, dh).astype(np.float32)
    g = rs.randn(b, h, sq, dh).astype(np.float32)
    mask = _mask(4, b, sk)
    mask[1] = 1

    def jfn(qp, kvp):
        kv = kvp.transpose(2, 0, 3, 1, 4)
        bias = jattn.make_additive_mask(jnp.asarray(mask)) if masked else None
        return jattn.attend(jattn.split_heads(qp, h), kv[0], kv[1],
                            scale=dh ** -0.5, bias=bias, impl="xla")

    ref, vjp = jax.vjp(jfn, jnp.asarray(qp), jnp.asarray(kvp))
    ref_grads = vjp(jnp.asarray(g))
    tq = torch.from_numpy(qp).requires_grad_(True)
    tkv = torch.from_numpy(kvp).requires_grad_(True)
    kv = tkv.permute(2, 0, 3, 1, 4)
    q, k, v = tattn.split_heads(tq, h), kv[0], kv[1]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    bias = tattn.make_additive_mask(torch.from_numpy(mask)) if masked else None
    got = tattn.attend(q, k, v, scale=dh ** -0.5, bias=bias)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD_TOL)
    for leaf, r in zip((tq, tkv), ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **GRAD_TOL)


def test_fully_masked_row_is_uniform_as_jax_attend_gives_it():
    """The mask is additive -1e9, not -inf: a row whose keys are all masked
    attends all of them alike."""
    q, k, v = _qkv(5, (2, 2, 6, 8), 9)
    mask = np.ones((2, 9), np.int32)
    mask[0] = 0
    ref = jattn.attend(*(jnp.asarray(x) for x in (q, k, v)), scale=0.3,
                       bias=jattn.make_additive_mask(jnp.asarray(mask)))
    got = tattn.attend(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.3,
                       bias=tattn.make_additive_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(v[0].mean(axis=-2, keepdims=True),
                                        (2, 6, 8)), **FWD_TOL)


def test_attend_takes_the_fused_path_unless_probabilities_are_dropped(
        monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, (2, 2, 5, 8), 7))
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    before = dict(_kernels.launch_counts)
    fused = tattn.attend(q, k, v, scale=0.3)
    assert len(calls) == 1 and calls[0]["scale"] == 0.3
    dropped = tattn.attend(q, k, v, scale=0.3, prob_dropout=0.5,
                           generator=torch.Generator().manual_seed(0))
    assert len(calls) == 1  # the plain code, not the fused path
    assert not torch.equal(fused, dropped)
    # on a CPU tensor the fused path is the kernel's plain version, bit for
    # bit, and launches nothing
    assert torch.equal(fused, flash.flash_attention_reference(q, k, v,
                                                              scale=0.3))
    torch.testing.assert_close(fused, tattn.attend_plain(q, k, v, scale=0.3))
    assert _kernels.launch_counts == before


def test_flash_attention_rejects_what_it_cannot_take():
    q = torch.zeros(2, 3, 5, 16)
    k = torch.zeros(2, 3, 7, 16)
    with pytest.raises(ValueError, match=r"\(2, 3, 5, 7\)"):  # varies over Sq
        flash.flash_attention(q, k, k, scale=1.0, bias=torch.zeros(2, 3, 5, 7))
    with pytest.raises(ValueError, match=r"\(2, 1, 1, 9\)"):  # other Sk
        flash.flash_attention(q, k, k, scale=1.0, bias=torch.zeros(2, 1, 1, 9))
    with pytest.raises(ValueError, match=r"\(2, 3, 5, 136\)"):  # Dh = 136
        flash.flash_attention(torch.zeros(2, 3, 5, 136),
                              torch.zeros(2, 3, 7, 136),
                              torch.zeros(2, 3, 7, 136), scale=1.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 7, 8\)"):  # v's width
        flash.flash_attention(q, k, k[..., :8], scale=1.0)
    with pytest.raises(ValueError, match="float16"):
        flash.flash_attention(q.half(), k.half(), k.half(), scale=1.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 0, 16\)"):  # no key
        flash.flash_attention(q, k[:, :, :0], k[:, :, :0], scale=1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                              scale=1.0)


# ---- K9's forms: their geometry, and the few-query forms' split-and-merge
# arithmetic

LOG2E = 1.4426950408889634


@pytest.mark.parametrize("sq, sk, b, h", [
    (15, 3137, 20, 12),  # t2i, EgoMCQ 16 frames
    (15, 3137, 5, 12),   # t2i, EgoMCQ 16 frames, one question: 3 splits
    (15, 3137, 64, 12),  # t2i, an NLQ inner batch
    (15, 981, 16, 12),   # t2i, QFVS
    (15, 785, 16, 12),   # t2i, EgoMCQ 4 frames
    (15, 15, 64, 12),    # text self-attention
    (30, 30, 8, 12),
    (32, 6273, 1, 2),
    (1, 1, 1, 1),
    (17, 64, 3, 5),
])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_fwd_geometry(sq, sk, b, h, dh):
    """The runs of keys cover Sk exactly, in multiples of the staged chunk;
    one split where Sk fits one run, and wherever B * H alone reaches
    FLASH_BLOCKS; otherwise the shortest run that gives at most
    ceil(FLASH_BLOCKS / (B * H)) splits, unless FLASH_MIN_RUN stops it; the
    shared memory holds the ring and the warps' partials and fits a
    block."""
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b, h)
    assert geo.form == "few_queries"
    chunk = _kernels.FLASH_CHUNK
    assert geo.run % chunk == 0 and geo.run >= chunk
    assert (geo.splits - 1) * geo.run < sk <= geo.splits * geo.run
    assert (geo.splits == 1) == (sk <= geo.run)
    assert geo.run <= -(-sk // chunk) * chunk
    assert geo.row_tiles == (1 if sq <= 16 else 2)
    want = -(-_kernels.FLASH_BLOCKS // (b * h))
    assert geo.splits <= want
    if b * h >= _kernels.FLASH_BLOCKS:
        assert geo.splits == 1
    if _kernels.FLASH_MIN_RUN < geo.run < -(-sk // chunk) * chunk:
        assert -(-sk // (geo.run - chunk)) > want
    assert geo.stages == _kernels.FLASH_STAGES
    rows = min(chunk, -(-sk // 16) * 16)
    ring = geo.stages * rows * 2 * (2 * (dh + 8) + 2)  # K, V, bias
    assert geo.shared_bytes == max(ring, 4 * (4 * 16 * dh + 2 * 4 * 16))
    assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX


def _tf32_row_bytes(dh):
    """A key's K, V (pitches dp + 8 and dp + 4 floats) and bias in the
    3xTF32 forms' shared memory, dp the padded head dim."""
    dp = _kernels.flash_tf32_dh(dh)
    return 4 * ((dp + 8) + (dp + 4) + 1)


@pytest.mark.parametrize("dtype, dh, sq, form", [
    (torch.bfloat16, 64, 33, "many_queries"),
    (torch.bfloat16, 64, 785, "many_queries"),
    (torch.bfloat16, 32, 3137, "many_queries"),
    (torch.bfloat16, 128, 981, "many_queries"),
    (torch.bfloat16, 40, 15, "few_queries_tf32"),
    (torch.bfloat16, 16, 15, "few_queries_tf32"),
    (torch.float32, 64, 15, "few_queries_tf32"),    # EgoTaskQA eval's t2i
    (torch.float32, 64, 785, "many_queries_tf32"),  # EgoTaskQA's i2t
    (torch.bfloat16, 12, 15, "few_queries_tf32"),
    (torch.bfloat16, 40, 37, "many_queries_tf32"),
    (torch.bfloat16, 12, 37, "many_queries_tf32"),
    (torch.bfloat16, 100, 785, "many_queries_tf32"),
    (torch.float32, 64, 30, "few_queries_tf32"),
    (torch.float32, 128, 3137, "many_queries_tf32"),
    (torch.float32, 7, 40, "many_queries_tf32"),
    (torch.float32, 12, 37, "many_queries_tf32"),
])
def test_flash_fwd_geometry_other_forms(dtype, dh, sq, form):
    """bf16 above 32 query rows at a tensor-core head dim is the bf16
    many-query form, over 15 keys its ring form; float32 at any head dim
    and bf16 at the others take the 3xTF32 forms, with the head dim padded
    to 16, 32, 64 or 128 and the shared memory of `flash_fwd_geometry`'s
    docstring. B=8, H=12; i2t over 15 keys above 32 query rows, t2i over
    785 keys at or below."""
    sk, b = (15 if sq > 32 else 785), 8
    geo = _kernels.flash_fwd_geometry(dtype, dh, sq, sk, b, 12)
    assert geo.form == form
    assert "cuda_cores" not in _kernels._FLASH_FORMS
    if form == "many_queries":
        assert (geo.key_tiles, geo.stages, geo.row_tiles) \
            == (1, _kernels.FLASH_RING_STAGES, None)
        assert (geo.splits - 1) * geo.run < sq <= geo.splits * geo.run
        assert geo.shared_bytes == _ring_shared_bytes(dh, 1, geo.stages)
    elif form == "many_queries_tf32":
        assert geo.splits == 1
        assert geo.run is geo.row_tiles is geo.stages is geo.key_tiles is None
        dp = _kernels.flash_tf32_dh(dh)
        assert geo.shared_bytes == 4 * 64 * (dp + 8) \
            + _kernels.FLASH_TF32_FWD_CHUNK * _tf32_row_bytes(dh)
        assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX
    else:
        assert geo.run % _kernels.FLASH_TF32_CHUNK == 0
        assert geo.splits == -(-sk // geo.run)
        assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX


def _ring_shared_bytes(dh, key_tiles, stages):
    """The ring form's K and V (16 key_tiles rows), the 4 warps' rings of
    16-row slabs (all at a pitch of Dh + 8 bf16) and the f32 bias."""
    keys = 16 * key_tiles
    return 2 * (2 * keys + 4 * stages * 16) * (dh + 8) + 4 * keys


@pytest.mark.parametrize("sq, sk, b", [
    (785, 15, 16),    # i2t, pretrain
    (3137, 15, 20),   # EgoMCQ 16 frames
    (3137, 15, 64),   # an NLQ inner batch
    (981, 15, 16),    # QFVS
    (785, 30, 8),     # the fine-tunes' 30 tokens: 128 rows a block
    (6273, 15, 2),    # 32 frames
    (64, 64, 16),     # 64 x 64: the most keys of the ring form
    (37, 33, 3),      # an odd Sq over 3 key tiles: compiled as 4
    (33, 1, 1),       # one key
    (256, 16, 1), (257, 17, 1), (512, 32, 1), (513, 63, 1),
])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_fwd_geometry_ring_form(sq, sk, b, dh):
    """The ring form's runs of query rows are FLASH_RING_ROWS (256), or
    shorter by a slab of 16 for each of the 4 warps at a time, down to 64,
    while the blocks of B * H (b, h) are fewer than FLASH_RING_BLOCKS; the
    runs cover Sq with a row for every block; 1, 2 or 4 key tiles; its
    shared memory fits a block; past FLASH_RING_KEYS keys the chunked
    form."""
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b, 12)
    assert geo.form == "many_queries"
    slab, most = _kernels.FLASH_RING_SLAB, _kernels.FLASH_RING_ROWS
    assert (slab, most) == (16, 256)
    assert geo.run % (4 * slab) == 0 and 4 * slab <= geo.run <= most
    assert geo.splits == -(-sq // geo.run)
    assert (geo.splits - 1) * geo.run < sq <= geo.splits * geo.run
    blocks = _kernels.FLASH_RING_BLOCKS
    if geo.run < most:  # shortened: the longer run had too few blocks
        assert b * 12 * -(-sq // (geo.run + 4 * slab)) < blocks
    if geo.run > 4 * slab:
        assert b * 12 * geo.splits >= blocks
    if (sq, sk, b) in ((3137, 15, 20), (3137, 15, 64), (981, 15, 16),
                       (785, 15, 16)):  # the path shapes
        assert geo.run == most
    assert geo.key_tiles == (1 if sk <= 16 else 2 if sk <= 32 else 4)
    assert geo.key_tiles == _kernels.flash_ring_key_tiles(sk)
    assert geo.stages == _kernels.FLASH_RING_STAGES
    assert geo.row_tiles is None
    assert geo.shared_bytes == _ring_shared_bytes(dh, geo.key_tiles,
                                                  geo.stages)
    assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX
    chunked = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, 65, b, 12)
    assert chunked.form == "many_queries_chunked"
    assert (chunked.splits, chunked.shared_bytes) == (1, None)
    assert chunked.run is chunked.row_tiles is chunked.stages \
        is chunked.key_tiles is None


@pytest.mark.parametrize("dtype, dh, sq, sk, b, splits", [
    (torch.bfloat16, 64, 3137, 15, 64, None),   # the ring form, 13 runs
    (torch.bfloat16, 64, 6273, 15, 8, None),    # 32 frames
    (torch.bfloat16, 64, 197, 197, 16, None),   # the chunked form
    (torch.float32, 64, 785, 15, 8, None),      # many_queries_tf32
    (torch.bfloat16, 64, 15, 3137, 5, 3),       # EgoMCQ's one question
    (torch.bfloat16, 64, 15, 3137, 64, 1),
    (torch.float32, 64, 15, 785, 8, 4),         # the TaskQA evaluation's t2i
])
def test_flash_fwd_scratch_only_for_split_few_query_forms(dtype, dh, sq, sk,
                                                           b, splits):
    """K9's f32 partials [B, H, splits, Sq, Dh + 2] exist only for a
    few-query form at more than one split: the ring form's splits are runs
    of query rows, written straight to the output, so it takes none."""
    geo = _kernels.flash_fwd_geometry(dtype, dh, sq, sk, b, 12)
    q = torch.empty((b, 12, sq, dh), dtype=dtype, device="meta")
    partials = _kernels.flash_fwd_scratch(q, geo)
    if splits is None:
        assert not geo.form.startswith("few_queries")
        assert partials is None
    else:
        assert geo.form.startswith("few_queries") and geo.splits == splits
        if splits == 1:
            assert partials is None
        else:
            assert partials.dtype == torch.float32
            assert tuple(partials.shape) == (b, 12, splits, sq, dh + 2)


@pytest.mark.parametrize("dh, pad", [(1, 16), (12, 16), (16, 16), (17, 32),
                                     (40, 64), (64, 64), (65, 128),
                                     (100, 128), (128, 128)])
def test_flash_tf32_pads_the_head_dim(dh, pad):
    assert _kernels.flash_tf32_dh(dh) == pad


@pytest.mark.parametrize("sq, sk, b, h", [
    (15, 785, 8, 12),    # t2i, the f32 EgoTaskQA evaluation: B*H = 96
    (15, 15, 8, 12),     # its text self-attention
    (15, 785, 16, 12),   # B*H = 192
    (15, 3137, 20, 12),  # 240
    (15, 3137, 32, 12),  # 384: FLASH_TF32_BLOCKS, one run
    (15, 3137, 64, 12),  # 768
    (30, 30, 8, 12),
    (32, 6273, 1, 2),
    (1, 1, 1, 1),
    (17, 64, 3, 5),
])
@pytest.mark.parametrize("dh", [12, 40, 64, 128])
def test_flash_fwd_geometry_tf32_few_queries(sq, sk, b, h, dh):
    """The 3xTF32 few-query form's runs of keys cover Sk in multiples of
    its 32-key chunk, one split wherever B * H reaches FLASH_TF32_BLOCKS or
    Sk fits one run; otherwise the shortest run that gives at most
    ceil(FLASH_TF32_BLOCKS / (B * H)) splits, unless FLASH_MIN_RUN stops it;
    the ring, the Q rows and the warps' partials fit a block."""
    geo = _kernels.flash_fwd_geometry(torch.float32, dh, sq, sk, b, h)
    assert geo.form == "few_queries_tf32"
    chunk = _kernels.FLASH_TF32_CHUNK
    assert geo.run % chunk == 0 and geo.run >= chunk
    assert (geo.splits - 1) * geo.run < sk <= geo.splits * geo.run
    assert geo.run <= -(-sk // chunk) * chunk
    assert geo.row_tiles == (1 if sq <= 16 else 2)
    want = -(-_kernels.FLASH_TF32_BLOCKS // (b * h))
    assert geo.splits <= want
    if b * h >= _kernels.FLASH_TF32_BLOCKS:
        assert geo.splits == 1
    if _kernels.FLASH_MIN_RUN < geo.run < -(-sk // chunk) * chunk:
        assert -(-sk // (geo.run - chunk)) > want
    if (sq, sk, b, h) == (15, 785, 8, 12):
        assert (geo.run, geo.splits) == (256, 4)
    assert geo.stages == _kernels.FLASH_STAGES
    kw = chunk * geo.row_tiles // 4  # keys a warp scores a chunk
    rows = min(chunk, -(-sk // kw) * kw)
    dp = _kernels.flash_tf32_dh(dh)
    ring = geo.stages * rows * _tf32_row_bytes(dh) \
        + 4 * 16 * geo.row_tiles * (dp + 8)
    assert geo.shared_bytes == max(ring, 4 * (4 * 16 * dp + 2 * 4 * 16))
    assert geo.shared_bytes <= _kernels.SHARED_BYTES_MAX


def test_flash_fwd_geometry_refuses_bad_input():
    geo = _kernels.flash_fwd_geometry
    with pytest.raises(TypeError, match="float16"):
        geo(torch.float16, 64, 15, 785, 2, 12)
    for bad in ((0, 15, 785, 2, 12), (129, 15, 785, 2, 12),
                (64, 0, 785, 2, 12), (64, 15, 0, 2, 12), (64, 15, 785, 0, 12),
                (64, 15, 785, 2, 0)):
        with pytest.raises(ValueError):
            geo(torch.bfloat16, *bad)


def _split_merge(q, k, v, bias, scale, run):
    """K9's few-query arithmetic in plain f32 torch: each run of keys gives
    its partial (the unnormalised output, the running max and sum, logits in
    the log2 domain), and the partials are merged in split order, o = sum
    o_s 2^(m_s - M) / sum l_s 2^(m_s - M). Returns the output and each
    split's weight 2^(m_s - M), [splits, ..., Sq, 1]."""
    parts = []
    for s0 in range(0, k.shape[-2], run):
        logits = q @ k[..., s0:s0 + run, :].transpose(-1, -2) * (scale * LOG2E)
        if bias is not None:
            logits = logits + bias[..., s0:s0 + run] * LOG2E
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp2(logits - m)
        parts.append((p @ v[..., s0:s0 + run, :], m, p.sum(dim=-1,
                                                           keepdim=True)))
    top = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    weights = torch.stack([torch.exp2(m - top) for _, m, _ in parts])
    num = sum(o * w for (o, _, _), w in zip(parts, weights))
    den = sum(l * w for (_, _, l), w in zip(parts, weights))
    return num / den, weights


SPLIT_CASES = [
    (785, None),            # t2i at 4 frames, several splits
    ("run", None),          # Sk = run: one split
    ("run+1", None),        # a last split of one key
    (785, "split"),         # one split's keys all masked, in rows with live keys
    (785, "row"),           # every key of batch row 0 masked
]


@pytest.mark.parametrize("sk, masking", SPLIT_CASES)
def test_split_merge_model_matches_reference_and_jax(sk, masking):
    """The split-and-merge arithmetic on the bf16 form's runs (128-key
    chunks), held against `flash_attention_reference` and the JAX package
    (Sq=15 < 32: the JAX function hands the call to XLA) in f32: a split
    whose keys are all masked weighs exactly 0, a fully masked row comes
    out uniform."""
    _check_split_merge(torch.bfloat16, sk, masking)


@pytest.mark.parametrize("sk, masking", SPLIT_CASES)
def test_split_merge_model_matches_reference_and_jax_tf32(sk, masking):
    """The same on the runs of the 3xTF32 form's geometry (32-key chunks,
    the split target FLASH_TF32_BLOCKS)."""
    _check_split_merge(torch.float32, sk, masking)


def _check_split_merge(dtype, sk, masking):
    b, h, sq, dh = 2, 3, 15, 64
    run = _kernels.flash_fwd_geometry(dtype, dh, sq, 785, b, h).run
    sk = {"run": run, "run+1": run + 1}.get(sk, sk)
    geo = _kernels.flash_fwd_geometry(dtype, dh, sq, sk, b, h)
    assert geo.run == run and geo.splits == -(-sk // run) \
        and (geo.splits > 1) == (sk > run)
    q, k, v = _qkv(11, (b, h, sq, dh), sk)
    mask = _mask(12, b, sk)
    if masking == "split":
        mask[1, run:2 * run] = 0
    elif masking == "row":
        mask[0] = 0
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tbias = tattn.make_additive_mask(torch.from_numpy(mask))
    got, weights = _split_merge(tq, tk, tv, tbias, dh ** -0.5, geo.run)
    ref = flash.flash_attention_reference(tq, tk, tv, scale=dh ** -0.5,
                                          bias=tbias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **FWD_TOL)
    jref = jattn.attend(*(jnp.asarray(x) for x in (q, k, v)),
                        scale=dh ** -0.5,
                        bias=jattn.make_additive_mask(jnp.asarray(mask)),
                        impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), **FWD_TOL)
    assert weights.shape == (geo.splits, b, h, sq, 1)
    if masking == "split":
        assert torch.all(weights[1, 1] == 0.0)  # exactly, not nearly
        assert torch.all(weights[:, 0].amax(dim=0) == 1.0)
    if masking == "row":
        uniform = v[0].mean(axis=-2, keepdims=True)
        np.testing.assert_allclose(
            got[0].numpy(), np.broadcast_to(uniform, (h, sq, dh)), **FWD_TOL)


def test_split_merge_model_matches_jax_pallas_at_32_rows():
    """At Sq = 32, the most rows of the few-query forms (two row tiles), the
    JAX function reaches its Pallas kernel (interpret mode): Sk = run + 1
    with a padding mask, on the bf16 form's runs."""
    _check_split_merge_at_32_rows(torch.bfloat16)


def test_split_merge_model_matches_jax_pallas_at_32_rows_tf32():
    """The same on the 3xTF32 form's runs."""
    _check_split_merge_at_32_rows(torch.float32)


def _check_split_merge_at_32_rows(dtype):
    b, h, sq, dh = 1, 2, 32, 32
    run = _kernels.flash_fwd_geometry(dtype, dh, sq, 785, b, h).run
    sk = run + 1
    geo = _kernels.flash_fwd_geometry(dtype, dh, sq, sk, b, h)
    assert (geo.splits, geo.row_tiles) == (2, 2)
    q, k, v = _qkv(13, (b, h, sq, dh), sk)
    mask = _mask(14, b, sk)
    jbias = jnp.broadcast_to(jattn.make_additive_mask(jnp.asarray(mask)),
                             (b, h, 1, sk))
    ref = _jax_pallas(q, k, v, bias=jbias)
    got, _ = _split_merge(*(torch.from_numpy(x) for x in (q, k, v)),
                          tattn.make_additive_mask(torch.from_numpy(mask)),
                          dh ** -0.5, geo.run)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


# ---- K9's ring form (bf16 i2t over at most 64 keys): its walk and
# arithmetic


def _ring_walk(q, k, v, bias, scale, geo):
    """K9's ring form in plain f32 torch, as its blocks walk: each (batch,
    head) in runs of `geo.run` query rows, a run cut into slabs of 16 rows
    that the block's 4 warps take in turn; each slab one pass over the keys
    (one chunk: the logits q.k scale + bias in the log2 domain, their max,
    exp2, the sum; no rescale) and P fed to P.V as hi + lo bf16 terms.
    Returns the output and how many times each row was written."""
    b, h, sq, _ = q.shape
    sk = k.shape[-2]
    out = torch.full_like(q, float("nan"))
    written = torch.zeros((b, h, sq), dtype=torch.int64)
    row_bias = torch.zeros((b, h, 1, sk)) if bias is None \
        else bias.expand(b, h, 1, sk)
    for split in range(geo.splits):
        r_begin = split * geo.run
        r_end = min(sq, r_begin + geo.run)
        slabs = -(-(r_end - r_begin) // 16)
        for warp in range(4):
            for slab in range(warp, slabs, 4):
                r0 = r_begin + 16 * slab
                r1 = min(r0 + 16, r_end)
                logits = (q[:, :, r0:r1] @ k.transpose(-1, -2)) \
                    * (scale * LOG2E) + row_bias * LOG2E
                p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                out[:, :, r0:r1] = (lo @ v + hi @ v) / p.sum(dim=-1,
                                                             keepdim=True)
                written[:, :, r0:r1] += 1
    return out, written


@pytest.mark.parametrize("sq", [50, 785])
def test_ring_walk_model_matches_jax_pallas(sq):
    """The ring form's walk and arithmetic on its geometry (B * H = 4:
    runs of 64 rows; Sq=50: one run of 4 slabs, the last of 2 rows;
    Sq=785: 13 runs, the last of 17 rows) over the
    i2t's 15 keys, k and v slices of one packed [B, Sk, 2, H, Dh]
    projection, a padding mask with batch row 0 fully masked: every row
    written once, within 2e-5 of `flash_attention_reference`, and of the
    JAX package's Pallas `_flash_fwd_3d` (interpret mode) in the batch row
    that has live keys; batch row 0 uniform over its 15 keys, as the plain
    version and JAX's `attend` give it (the Pallas kernel pads the keys to
    128 with the -1e9 of a masked key, so it spreads such a row over the
    padding too: 15/128 of the mean). The inputs are bf16 values, as the
    kernel's: the products q.k are exact in f32."""
    b, h, sk, dh = 2, 2, 15, 32
    geo = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b, h)
    assert geo.form == "many_queries"
    rs = np.random.RandomState(sq)

    def bf16_values(*shape):
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        return x.to(torch.bfloat16).float()

    q = bf16_values(b, sq, h, dh).transpose(1, 2)
    kv = bf16_values(b, sk, 2, h, dh).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    mask = _mask(sq, b, sk)
    mask[0] = 0
    bias = tattn.make_additive_mask(torch.from_numpy(mask))
    got, written = _ring_walk(q, k, v, bias, dh ** -0.5, geo)
    assert torch.all(written == 1)
    flat = [np.ascontiguousarray(t.numpy()).reshape(b * h, -1, dh)
            for t in (q, k, v)]
    bias_rows = np.broadcast_to(bias.numpy()[:, :, 0], (b, h, sk))
    with pltpu.force_tpu_interpret_mode():
        ref = jflash._flash_fwd_3d(*(jnp.asarray(x) for x in flat),
                                   jnp.asarray(bias_rows.reshape(b * h, sk)),
                                   dh ** -0.5)
    np.testing.assert_allclose(got.reshape(b * h, sq, dh).numpy()[h:],
                               np.asarray(ref)[h:], **FWD_TOL)
    np.testing.assert_allclose(
        got.numpy(), flash.flash_attention_reference(
            q, k, v, scale=dh ** -0.5, bias=bias).numpy(), **FWD_TOL)
    uniform = v[0].mean(dim=-2, keepdim=True).expand(h, sq, dh)
    np.testing.assert_allclose(got[0].numpy(), uniform.numpy(), **FWD_TOL)
