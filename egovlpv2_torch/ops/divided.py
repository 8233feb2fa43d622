"""Divided space-time attention with the CLS splice (port of
`egovlpv2_tpu/ops/divided.py`).

Semantics of the reference `EgoVLPv2/model/video_transformer.py:117-153`,
as `_divided_xla` states them: the CLS query attends the whole sequence;
a patch query attends the patches of its own frame (space axis) or of its
own patch column across frames (time axis), plus the CLS key.

`divided_attention` dispatches on the device of its input:
  * a CPU tensor takes the plain PyTorch version,
    `divided_attention_reference`, and autograd differentiates it;
  * a CUDA tensor takes the hand-written kernels of `csrc/`, chosen by one
    predicate, `grouped_kernels_take` (dtype, head dim, contiguity,
    alignment):
      - bf16, contiguous, 16-byte aligned, head dim a multiple of 8 up to
        128: forward K1 space or K2 time for rows 1..S-1 and K3 for the CLS
        row, backward K4 space or K5 time, then K6 for the CLS row (from
        K3's output and log-sum-exp, no forward recomputed); they read q, k
        and v by stride from the qkv Linear output and write dqkv in the
        same layout;
      - any other float32 or bf16 input (f32, another head dim, a strided
        view such as a permute of a [3, B, H, S, Dh] tensor): K10 forward
        and K11 backward (`csrc/divided_attention_general.cu`), which read
        every tensor by its strides, without a copy;
    another dtype raises, and a kernel that cannot build or launch raises;
  * any other device raises.

`divided_attention_backward_reference` is the plain version of the
backward: autograd through `divided_attention_reference`. The tests and
`chip_smoke.py` hold K4-K6 and K11 against it; nothing on the card's path
calls it. Nor does it call the plain versions of what K3 and K6 keep
between their launches: `cls_run_partials_reference` and
`merge_cls_run_partials_reference` (K3's partials of the CLS row over
runs of keys, their merge and the row's log-sum-exp lse0, which K6
reads), `cls_run_grad_reference` (K6's one pass over the keys: the
partials of dq0 and the CLS query's share of every dk/dv row),
`time_column_reference` (K2's tensor-core block: the exact softmax of a
patch column, its numerator rounded before the product with V),
`time_column_grad_reference` (K5's tensor-core block: both passes of a
patch column, and the blocks' partials of the CLS key's dk/dv),
`space_frame_reference` and `space_frame_grad_reference` (K1's and K4's
frame blocks: the same for a frame, and each frame's dk/dv of the CLS
key); nor those
of what K10 and K11 keep between theirs: `row_lse_reference` (K10's
log-sum-exp of each row, which K11 reads), `cls_row_partials_reference` and
`merge_cls_partials_reference` (K10's split of the CLS row across the
groups and its merge), `cls_grad_partials_reference` and
`merge_cls_grad_reference` (K11's per-group partials of row 0's gradient
and their merge).
"""

from __future__ import annotations

import torch

from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.ops.attention import attend_plain

_AXES = ("space", "time")


def cls_row_reference(qkv: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Row 0 of the output: the CLS query over all S keys. [B, 1, H, Dh]."""
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, S, Dh] each
    return attend_plain(q[:, :, :1], k, v, scale=scale).transpose(1, 2)


def grouped_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                      num_frames: int) -> torch.Tensor:
    """Rows 1..S-1 of the output: each patch query over its frame (space)
    or its patch column (time) plus the CLS key. [B, S-1, H, Dh]."""
    if axis not in _AXES:
        raise ValueError(f"axis must be one of {_AXES}, got {axis!r}")
    b, s, _, h, dh = qkv.shape
    f = num_frames
    n = (s - 1) // f
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def grouped(t):
        t = t[:, :, 1:].reshape(b, h, f, n, dh)
        return t.transpose(2, 3) if axis == "time" else t

    qg, kg, vg = grouped(q), grouped(k), grouped(v)
    g = qg.shape[2]
    kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, dh), kg], dim=3)
    vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, dh), vg], dim=3)
    out = attend_plain(qg, kg, vg, scale=scale)
    if axis == "time":
        out = out.transpose(2, 3)
    return out.reshape(b, h, f * n, dh).transpose(1, 2)


def divided_attention_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                                num_frames: int) -> torch.Tensor:
    """Plain PyTorch divided attention: qkv [B, S, 3, H, Dh] -> [B, S, H, Dh]."""
    return torch.cat([
        cls_row_reference(qkv, scale=scale),
        grouped_reference(qkv, scale=scale, axis=axis, num_frames=num_frames),
    ], dim=1)


def cls_run_partials_reference(qkv: torch.Tensor, *,
                               scale: float) -> torch.Tensor:
    """The plain version of K3's first launch: for each run of keys of
    `_kernels.cls_row_geometry` (keys part * run .. part * run + run - 1,
    the last run cut at S), the CLS query over that run as (m, l, acc):
    the largest logit scale * q0.k, the sum of exp(logit - m) and the sum
    of exp(logit - m) * v. qkv [B, S, 3, H, Dh] -> f32 [B, H, parts,
    Dh + 2]. Nothing on the card's path calls it."""
    b, s, _, h, dh = qkv.shape
    geo = _kernels.cls_row_geometry(qkv.dtype, dh, s)
    x = qkv.float()
    logits = torch.einsum("bhd,bshd->bhs", x[:, 0, 0], x[:, :, 1]) * scale
    parts = []
    for part in range(geo.parts):
        keys = slice(part * geo.run, (part + 1) * geo.run)
        m = logits[..., keys].amax(-1)
        p = torch.exp(logits[..., keys] - m[..., None])
        acc = torch.einsum("bhr,brhd->bhd", p, x[:, keys, 2])
        parts.append(torch.cat([m[..., None], p.sum(-1)[..., None], acc], -1))
    return torch.stack(parts, dim=2)


def merge_cls_run_partials_reference(partials: torch.Tensor) -> tuple:
    """The plain version of K3's second launch: the partials [B, H, parts,
    Dh + 2] of `cls_run_partials_reference` merged in part order into the
    CLS row's output [B, H, Dh] and its log-sum-exp lse0 [B, H] (natural
    log), which K6 reads."""
    m, l = partials[..., 0], partials[..., 1]
    top = m.amax(-1)
    lse0 = top + torch.log((l * torch.exp(m - top[..., None])).sum(-1))
    return merge_cls_partials_reference(partials), lse0


def cls_run_grad_reference(qkv: torch.Tensor, g: torch.Tensor,
                           out0: torch.Tensor, lse0: torch.Tensor, *,
                           scale: float) -> tuple:
    """The plain version of K6's one pass over the keys, from K3's output
    row out0 [B, H, Dh] and lse0 [B, H]: with p_j = exp(scale q0.k_j -
    lse0), delta0 = g0.out0 and ds_j = p_j (g0.v_j - delta0), returns in
    f32
      * the partials of dq0 / scale, sum_j ds_j k_j over each run of keys
        of `_kernels.cls_row_geometry`, [B, H, parts, Dh] (dq0 is scale
        times their sum in part order);
      * the CLS query's share of every key's dk, scale ds_j q0, and of its
        dv, p_j g0, [B, S, H, Dh] each (K6 adds them to the rows K4/K5
        wrote, and key 0's to the sum of K4/K5's `cls_part`).
    qkv [B, S, 3, H, Dh], g [B, S, H, Dh]. Nothing on the card's path
    calls it."""
    b, s, _, h, dh = qkv.shape
    geo = _kernels.cls_row_geometry(qkv.dtype, dh, s)
    x, g0 = qkv.float(), g[:, 0].float()
    q0, k, v = x[:, 0, 0], x[:, :, 1], x[:, :, 2]
    delta0 = (g0 * out0.float()).sum(-1)  # [B, H]
    p = torch.exp(torch.einsum("bhd,bshd->bhs", q0, k) * scale
                  - lse0[..., None])
    ds = p * (torch.einsum("bhd,bshd->bhs", g0, v) - delta0[..., None])
    dq_parts = torch.stack([
        torch.einsum("bhr,brhd->bhd", ds[..., keys], k[:, keys])
        for keys in (slice(part * geo.run, (part + 1) * geo.run)
                     for part in range(geo.parts))], dim=2)
    dkd = scale * torch.einsum("bhs,bhd->bshd", ds, q0)
    dvd = torch.einsum("bhs,bhd->bshd", p, g0)
    return dq_parts, dkd, dvd


def _groups(t: torch.Tensor, num_frames: int, axis: str) -> torch.Tensor:
    """[B, S, H, Dh] -> the patch rows by group, [B, H, G, L, Dh]: the
    frames [B, H, F, N, Dh] (space) or the patch columns [B, H, N, F, Dh]
    (time)."""
    b, s, h, dh = t.shape
    n = (s - 1) // num_frames
    x = t[:, 1:].reshape(b, num_frames, n, h, dh).permute(0, 3, 1, 2, 4)
    return x if axis == "space" else x.transpose(2, 3)


def _groups_with_cls(t: torch.Tensor, num_frames: int,
                     axis: str) -> torch.Tensor:
    """The groups [B, H, G, L + 1, Dh] of `_groups` with the CLS row in
    front of each."""
    grp = _groups(t, num_frames, axis)
    b, h, g, _, dh = grp.shape
    return torch.cat([t[:, 0][:, :, None, None].expand(b, h, g, 1, dh), grp],
                     dim=3)


def _from_groups(t: torch.Tensor, axis: str) -> torch.Tensor:
    """The groups [B, H, G, L, Dh] of `_groups` back to rows 1..S-1,
    [B, S-1, H, Dh] (row 1 + f * N + n)."""
    if axis == "time":
        t = t.transpose(2, 3)
    b, h, f, n, dh = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, f * n, h, dh)


def _block_attention(qkv: torch.Tensor, scale: float, num_frames: int,
                     axis: str) -> torch.Tensor:
    """Each group's queries over the CLS key and the group's keys, the
    exact softmax in f32 with its numerator E = exp(scale Q K^T - row max)
    rounded to qkv's dtype before E V, and that product divided by the f32
    sum of E. qkv [B, S, 3, H, Dh] -> rows 1..S-1, [B, S-1, H, Dh] in qkv's
    dtype."""
    x = qkv.float()
    q = _groups(x[:, :, 0], num_frames, axis)
    k = _groups_with_cls(x[:, :, 1], num_frames, axis)
    v = _groups_with_cls(x[:, :, 2], num_frames, axis)
    logits = torch.einsum("bhgid,bhgjd->bhgij", q, k) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bhgij,bhgjd->bhgid", e.to(qkv.dtype).float(), v) \
        / e.sum(-1, keepdim=True)
    return _from_groups(out, axis).to(qkv.dtype)


def time_column_reference(qkv: torch.Tensor, *, scale: float,
                          num_frames: int) -> torch.Tensor:
    """The plain version of K2's tensor-core block: for each patch column
    of each (batch, head), its F queries over the CLS key and its F frames'
    keys, the exact softmax in f32 with its numerator E = exp(scale Q K^T -
    row max) rounded to qkv's dtype before E V, and that product divided by
    the f32 sum of E, as the kernel computes it. qkv [B, S, 3, H, Dh] ->
    rows 1..S-1, [B, S-1, H, Dh] in qkv's dtype. Nothing on the card's path
    calls it."""
    return _block_attention(qkv, scale, num_frames, "time")


def space_frame_reference(qkv: torch.Tensor, *, scale: float,
                          num_frames: int) -> torch.Tensor:
    """The plain version of K1's frame block: for each frame of each
    (batch, head), its N queries over the CLS key and its N keys, computed
    and rounded as `time_column_reference` does a patch column. qkv
    [B, S, 3, H, Dh] -> rows 1..S-1, [B, S-1, H, Dh] in qkv's dtype.
    Nothing on the card's path calls it."""
    return _block_attention(qkv, scale, num_frames, "space")


def _block_grad(qkv: torch.Tensor, g: torch.Tensor, scale: float,
                num_frames: int, axis: str, round_dp: bool) -> tuple:
    """Both passes of each group's block: P = softmax(scale Q K^T) over the
    CLS key and the group's keys, dP = G V^T, delta = sum P dP and dS = P
    (dP - delta) in f32, P and dS rounded to qkv's dtype before dQ = scale
    dS K, dK = scale dS^T Q and dV = P^T G (`round_dp`: P and dP rounded
    before delta too). Returns in f32 dqkv [B, S, 3, H, Dh] (rows 1..S-1,
    row 0 zero) and each group's dk and dv of the CLS key, [B, H, G, 2,
    Dh]."""
    x, gf = qkv.float(), g.float()
    q = _groups(x[:, :, 0], num_frames, axis)
    k = _groups_with_cls(x[:, :, 1], num_frames, axis)
    v = _groups_with_cls(x[:, :, 2], num_frames, axis)
    go = _groups(gf, num_frames, axis)
    p = torch.softmax(torch.einsum("bhgid,bhgjd->bhgij", q, k) * scale, -1)
    dp = torch.einsum("bhgid,bhgjd->bhgij", go, v)
    if round_dp:
        p, dp = p.to(qkv.dtype).float(), dp.to(qkv.dtype).float()
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    p, ds = p.to(qkv.dtype).float(), ds.to(qkv.dtype).float()
    dq = scale * torch.einsum("bhgij,bhgjd->bhgid", ds, k)
    dk = scale * torch.einsum("bhgij,bhgid->bhgjd", ds, q)
    dv = torch.einsum("bhgij,bhgid->bhgjd", p, go)
    dqkv = x.new_zeros(x.shape)
    for c, t in enumerate((dq, dk[:, :, :, 1:], dv[:, :, :, 1:])):
        dqkv[:, 1:, c] = _from_groups(t, axis)
    return dqkv, torch.stack([dk[:, :, :, 0], dv[:, :, :, 0]], dim=3)


def time_column_grad_reference(qkv: torch.Tensor, g: torch.Tensor, *,
                               scale: float, num_frames: int,
                               cols: int = _kernels.TIME_BWD_COLS) -> tuple:
    """The plain version of K5's tensor-core block: for each patch column
    of each (batch, head), its F queries over the CLS key and its F frames'
    keys, with P = softmax(scale Q K^T), dP = G V^T, delta = sum P dP and
    dS = P (dP - delta) in f32, and P and dS rounded to qkv's dtype before
    dQ = scale dS K, dK = scale dS^T Q and dV = P^T G, as the kernel rounds
    them. Returns in f32
      * dqkv [B, S, 3, H, Dh]: dq, dk and dv of rows 1..S-1 (the patch rows'
        time attention alone; K6 adds the CLS query's share), row 0 zero;
      * the blocks' partials of the CLS key's dk and dv, [B, H, parts, 2,
        Dh]: block p sums its `cols` columns p * cols.. in order (parts =
        ceil(N / cols), the `cls_part` of `_kernels.time_bwd_geometry`).
    qkv [B, S, 3, H, Dh], g [B, S, H, Dh]. Nothing on the card's path calls
    it."""
    dqkv, cls = _block_grad(qkv, g, scale, num_frames, "time", False)
    n = cls.shape[2]
    parts = []
    for c0 in range(0, n, cols):
        total = cls[:, :, c0]
        for c in range(c0 + 1, min(n, c0 + cols)):
            total = total + cls[:, :, c]
        parts.append(total)
    return dqkv, torch.stack(parts, dim=2)


def space_frame_grad_reference(qkv: torch.Tensor, g: torch.Tensor, *,
                               scale: float, num_frames: int) -> tuple:
    """The plain version of K4's frame block: for each frame of each
    (batch, head), its N queries over the CLS key and its N keys, with P =
    softmax(scale Q K^T), dP = G V^T, delta = sum P dP and dS = P (dP -
    delta) in f32, P rounded to qkv's dtype only before dV = P^T G and dS
    only before dQ = scale dS K and dK = scale dS^T Q, as the TPU kernel's
    frame-block backward and both passes of K4 round them. Returns in f32
      * dqkv [B, S, 3, H, Dh]: dq, dk and dv of rows 1..S-1 (the patch rows'
        space attention alone; K6 adds the CLS query's share), row 0 zero;
      * each frame's dk and dv of the CLS key, [B, H, F, 2, Dh]: the
        `cls_part` of `_kernels.space_bwd_geometry`'s frame form (parts =
        F), which K6 sums over the frames in order.
    qkv [B, S, 3, H, Dh], g [B, S, H, Dh]. Nothing on the card's path calls
    it."""
    return _block_grad(qkv, g, scale, num_frames, "space", False)


def live_mask(s: int, num_frames: int, axis: str,
              device=None) -> torch.Tensor:
    """[S, S] bool: whether query row i attends key row j. Row 0 and the
    CLS key everywhere; two patch rows where they share a frame (space) or
    a patch column (time)."""
    i = torch.arange(s - 1, device=device)
    n = (s - 1) // num_frames
    group = i // n if axis == "space" else i % n
    live = torch.ones((s, s), dtype=torch.bool, device=device)
    live[1:, 1:] = group[:, None] == group[None, :]
    return live


def row_lse_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                      num_frames: int) -> torch.Tensor:
    """The plain version of K10's `lse`: each row's log-sum-exp of its live
    logits scale * q.k, natural log, in f32. qkv [B, S, 3, H, Dh] ->
    [B, H, S]."""
    q, k, _ = qkv.float().permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, S, Dh]
    logits = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    live = live_mask(qkv.shape[1], num_frames, axis, qkv.device)
    return logits.masked_fill(~live, float("-inf")).logsumexp(-1)


def _cls_group_rows(g: int, geometry, axis: str, num_frames: int,
                    n: int) -> torch.Tensor:
    """The sequence rows whose keys group `g` of K10 gives the CLS query:
    its frame (space) or its run of `geometry.cols` patch columns over all
    frames (time), frame-major; group 0 also the CLS key (row 0)."""
    if axis == "space":
        rows = 1 + g * n + torch.arange(n)
    else:
        c0 = g * geometry.cols
        cols = torch.arange(c0, min(n, c0 + geometry.cols))
        rows = (1 + torch.arange(num_frames)[:, None] * n + cols).reshape(-1)
    return torch.cat([torch.zeros(1, dtype=rows.dtype), rows]) if g == 0 \
        else rows


def cls_row_partials_reference(qkv: torch.Tensor, *, scale: float, axis: str,
                               num_frames: int) -> torch.Tensor:
    """The plain version of K10's partials of the CLS query row: for each
    group of `_kernels.general_fwd_geometry` (a frame on the space axis, a
    run of patch columns on the time axis), the CLS query over that group's
    keys as (m, l, acc): the largest logit scale * q.k, the sum of
    exp(logit - m) and the sum of exp(logit - m) * v. qkv [B, S, 3, H, Dh]
    -> f32 [B, H, parts, Dh + 2]. Nothing on the card's path calls it."""
    b, s, _, h, dh = qkv.shape
    geo = _kernels.general_fwd_geometry(qkv.dtype, dh, s, num_frames, axis)
    n = (s - 1) // num_frames
    q0 = qkv[:, 0, 0].float()  # [B, H, Dh]
    parts = []
    for g in range(geo.parts):
        rows = _cls_group_rows(g, geo, axis, num_frames, n)
        k, v = qkv[:, rows, 1].float(), qkv[:, rows, 2].float()  # [B, R, H, Dh]
        logits = torch.einsum("bhd,brhd->bhr", q0, k) * scale
        m = logits.amax(-1)
        p = torch.exp(logits - m[..., None])
        acc = torch.einsum("bhr,brhd->bhd", p, v)
        parts.append(torch.cat([m[..., None], p.sum(-1)[..., None], acc], -1))
    return torch.stack(parts, dim=2)


def merge_cls_partials_reference(partials: torch.Tensor) -> torch.Tensor:
    """The plain version of K10's second launch: the partials [B, H, parts,
    Dh + 2] of `cls_row_partials_reference`, merged in group order into the
    CLS row's output [B, H, Dh]."""
    m, l, acc = partials[..., 0], partials[..., 1], partials[..., 2:]
    w = torch.exp(m - m.amax(-1, keepdim=True))  # [B, H, parts]
    return (acc * w[..., None]).sum(2) / (l * w).sum(2)[..., None]


def cls_grad_partials_reference(qkv: torch.Tensor, g: torch.Tensor, *,
                                scale: float, axis: str,
                                num_frames: int) -> torch.Tensor:
    """The plain version of K11's per-group scratch of row 0: for each
    group of `_kernels.general_bwd_geometry`, with R its rows (group 0 also
    row 0, the CLS row), P_ij = exp(scale q_i.k_j - lse_i) and dS_ij = P_ij
    (g_i.v_j - g_i.o_i):
      0: the CLS query's dq over the group's keys, sum_{j in R} dS_0j k_j;
      1: the CLS key's dk from the group's queries, sum_{i in R} dS_i0 q_i;
      2: its dv, sum_{i in R} P_i0 g_i;
    before scale (dq and dk), in f32. qkv [B, S, 3, H, Dh], g [B, S, H, Dh]
    -> [B, H, parts, 3, Dh]. Nothing on the card's path calls it."""
    b, s, _, h, dh = qkv.shape
    geo = _kernels.general_bwd_geometry(qkv.dtype, dh, s, num_frames, axis)
    kw = dict(scale=scale, axis=axis, num_frames=num_frames)
    x, gf = qkv.float(), g.float()
    lse = row_lse_reference(x, **kw)  # [B, H, S]
    delta = (gf * divided_attention_reference(x, **kw)).sum(-1)  # [B, S, H]
    q, k, v = x.unbind(2)  # [B, S, H, Dh]
    n = (s - 1) // num_frames
    parts = []
    for grp in range(geo.parts):
        rows = _cls_group_rows(grp, geo, axis, num_frames, n)
        # the CLS query over the group's keys
        p0 = torch.exp(torch.einsum("bhd,brhd->bhr", q[:, 0], k[:, rows])
                       * scale - lse[:, :, :1])
        ds0 = p0 * (torch.einsum("bhd,brhd->bhr", gf[:, 0], v[:, rows])
                    - delta[:, :1].transpose(1, 2))
        dq = torch.einsum("bhr,brhd->bhd", ds0, k[:, rows])
        # the group's queries on the CLS key
        pi = torch.exp(torch.einsum("brhd,bhd->bhr", q[:, rows], k[:, 0])
                       * scale - lse[:, :, rows])
        dsi = pi * (torch.einsum("brhd,bhd->bhr", gf[:, rows], v[:, 0])
                    - delta[:, rows].transpose(1, 2))
        dk = torch.einsum("bhr,brhd->bhd", dsi, q[:, rows])
        dv = torch.einsum("bhr,brhd->bhd", pi, gf[:, rows])
        parts.append(torch.stack([dq, dk, dv], dim=2))
    return torch.stack(parts, dim=2)


def merge_cls_grad_reference(partials: torch.Tensor, *,
                             scale: float) -> torch.Tensor:
    """The plain version of K11's third launch: the partials [B, H, parts,
    3, Dh] of `cls_grad_partials_reference` summed in group order, dq and
    dk times scale: row 0 of dqkv, [B, 3, H, Dh]."""
    total = partials[:, :, 0]
    for x in range(1, partials.shape[2]):
        total = total + partials[:, :, x]
    mul = torch.tensor([scale, scale, 1.0], dtype=total.dtype,
                       device=total.device)
    return (total * mul[:, None]).transpose(1, 2)


def divided_attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                        *, scale: float, axis: str,
                                        num_frames: int,
                                        rows: str = "all") -> torch.Tensor:
    """Plain PyTorch backward: the gradient of sum(out * g) w.r.t. qkv.

    qkv [B, S, 3, H, Dh], g [B, S, H, Dh] -> dqkv [B, S, 3, H, Dh] in
    qkv.dtype. `rows` picks the part of the output that is differentiated:
    "all", "grouped" (rows 1..S-1, what K4/K5 compute) or "cls" (row 0,
    what K6 computes); g keeps its full shape either way."""
    leaf = qkv.detach().requires_grad_(True)
    with torch.enable_grad():
        if rows == "all":
            out = divided_attention_reference(leaf, scale=scale, axis=axis,
                                              num_frames=num_frames)
        elif rows == "grouped":
            out, g = grouped_reference(leaf, scale=scale, axis=axis,
                                       num_frames=num_frames), g[:, 1:]
        elif rows == "cls":
            out, g = cls_row_reference(leaf, scale=scale), g[:, :1]
        else:
            raise ValueError(f"rows must be all, grouped or cls, got {rows!r}")
        (dqkv,) = torch.autograd.grad(out, leaf, g)
    return dqkv


class _DividedAttentionKernels(torch.autograd.Function):
    """The CUDA kernels as one differentiable function of the flat qkv
    [B, S, 3*H*Dh] -> [B, S, H*Dh]. Saves qkv, the output (which the proj
    Linear saves anyway, as its input) and K3's log-sum-exp of row 0, lse0
    [B, H] (f32, B*H floats): K4/K5 recompute the patch rows' softmax from
    qkv, K6 reads lse0 and the output's row 0 and recomputes no forward."""

    @staticmethod
    def forward(ctx, flat, num_heads, num_frames, scale, axis):
        b, s, w3 = flat.shape
        out = torch.empty((b, s, w3 // 3), dtype=flat.dtype,
                          device=flat.device)
        lse0 = torch.empty((b, num_heads), dtype=torch.float32,
                           device=flat.device)
        grouped_fwd = (_kernels.space_attention_fwd if axis == "space"
                       else _kernels.time_attention_fwd)
        grouped_fwd(flat, out, num_heads=num_heads, num_frames=num_frames,
                    scale=scale)
        _kernels.cls_row_attention_fwd(flat, out, lse0, num_heads=num_heads,
                                       scale=scale)
        ctx.save_for_backward(flat, out, lse0)
        ctx.attrs = (num_heads, num_frames, scale, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        flat, out, lse0 = ctx.saved_tensors
        num_heads, num_frames, scale, axis = ctx.attrs
        # Autograd may hand over a view (of the proj Linear's input grad);
        # the kernels read rows by one stride, so it is copied then.
        g = g.contiguous()
        dqkv = torch.empty_like(flat)
        stats, cls_part = _kernels.attention_bwd_scratch(
            flat, num_heads=num_heads, num_frames=num_frames, axis=axis)
        grouped_bwd = (_kernels.space_attention_bwd if axis == "space"
                       else _kernels.time_attention_bwd)
        grouped_bwd(flat, g, dqkv, stats, cls_part, num_heads=num_heads,
                    num_frames=num_frames, scale=scale)
        _kernels.cls_row_attention_bwd(flat, g, out, lse0, dqkv, cls_part,
                                       num_heads=num_heads, scale=scale)
        return dqkv, None, None, None, None


class _DividedAttentionGeneral(torch.autograd.Function):
    """K10 and K11 as one differentiable function of qkv [B, S, 3, H, Dh]
    (any strides) -> [B, S, H, Dh]. Saves qkv, the output (which the proj
    Linear saves anyway, as its input) and K10's f32 log-sum-exp of each
    row [B, H, S], so K11 does not recompute the forward. dqkv takes qkv's
    strides where qkv is dense (a permuted tensor), else it is contiguous;
    the cotangent is read as it comes."""

    @staticmethod
    def forward(ctx, qkv, scale, axis, num_frames):
        b, s, _, h, dh = qkv.shape
        out = torch.empty((b, s, h, dh), dtype=qkv.dtype, device=qkv.device)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=qkv.device)
        _kernels.divided_attention_general_fwd(qkv, out, lse, scale=scale,
                                               axis=axis,
                                               num_frames=num_frames)
        ctx.save_for_backward(qkv, out, lse)
        ctx.attrs = (scale, axis, num_frames)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        scale, axis, num_frames = ctx.attrs
        dqkv = torch.empty_like(qkv)
        _kernels.divided_attention_general_bwd(qkv, out, lse, g, dqkv,
                                               scale=scale, axis=axis,
                                               num_frames=num_frames)
        return dqkv, None, None, None


def grouped_kernels_take(qkv: torch.Tensor) -> bool:
    """Whether K1-K6 take this CUDA qkv [B, S, 3, H, Dh]: bf16, contiguous,
    16-byte aligned, head dim a multiple of 8 up to 128. K10/K11 take every
    other float32 or bf16 input."""
    dh = qkv.shape[-1]
    return (qkv.dtype == torch.bfloat16 and qkv.is_contiguous()
            and qkv.data_ptr() % 16 == 0 and dh % 8 == 0 and dh <= 128)


def divided_attention(qkv: torch.Tensor, *, scale: float, axis: str,
                      num_frames: int) -> torch.Tensor:
    """Divided space/time self-attention with the CLS splice.

    qkv: [B, S, 3, H, Dh], as a rule the reshape of the qkv Linear output,
    with S = 1 + num_frames * N. Returns [B, S, H, Dh] in qkv.dtype.
    """
    if axis not in _AXES:
        raise ValueError(f"axis must be one of {_AXES}, got {axis!r}")
    if qkv.device.type == "cpu":
        return divided_attention_reference(qkv, scale=scale, axis=axis,
                                           num_frames=num_frames)
    if qkv.device.type != "cuda":
        raise ValueError(f"divided_attention runs on cpu or cuda, not "
                         f"{qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"divided_attention on cuda takes float32 or "
                        f"bfloat16, got {qkv.dtype}")
    if not grouped_kernels_take(qkv):
        return _DividedAttentionGeneral.apply(qkv, scale, axis, num_frames)
    b, s, _, h, dh = qkv.shape
    out = _DividedAttentionKernels.apply(qkv.view(b, s, 3 * h * dh), h,
                                         num_frames, scale, axis)
    return out.view(b, s, h, dh)
