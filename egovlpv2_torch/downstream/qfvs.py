"""QFVS: kernel temporal segmentation (port of the KTS part of
`egovlpv2_tpu/downstream/qfvs.py`; numpy only).

Capability-parity target: `QFVS/segment/cpd_auto.py` + `cpd_nonlin.py` —
kernel temporal segmentation (KTS): dynamic programming over kernelized
scatters with automatic selection of the change-point count. The
reference's O(n^2) python loops are vectorized with numpy, as in the JAX
package. The summary scorer and the matching F1 of that module are not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def calc_scatters(K: np.ndarray) -> np.ndarray:
    """Kernelized scatter of every segment [i, j] (cpd_nonlin.py:10-22),
    vectorized: scatters[i,j] = sum(diag K[i..j]) - blocksum(i..j)/(j-i+1)."""
    n = K.shape[0]
    K1 = np.concatenate([[0], np.cumsum(np.diag(K))])
    K2 = np.zeros((n + 1, n + 1))
    K2[1:, 1:] = np.cumsum(np.cumsum(K, 0), 1)
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    diag_sum = K1[j + 1] - K1[i]
    block = K2[j + 1, j + 1] + K2[i, i] - K2[j + 1, i] - K2[i, j + 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        scat = diag_sum - block / (j - i + 1)
    return np.where(j >= i, scat, 0.0)


def cpd_nonlin(K: np.ndarray, ncp: int, lmin: int = 1, lmax: int = 100000,
               backtrack: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """DP change-point detection (cpd_nonlin.py:24-96), inner loop vectorized."""
    m = int(ncp)
    n = K.shape[0]
    assert n >= (m + 1) * lmin and n <= (m + 1) * lmax
    J = calc_scatters(K)
    I = 1e101 * np.ones((m + 1, n + 1))
    I[0, lmin:lmax] = J[0, lmin - 1:lmax - 1]
    p = np.zeros((m + 1, n + 1), dtype=int)

    for k in range(1, m + 1):
        for l in range((k + 1) * lmin, n + 1):
            lo = max(k * lmin, l - lmax)
            hi = l - lmin + 1
            c = I[k - 1, lo:hi] + J[lo:hi, l - 1]
            t = int(np.argmin(c))
            I[k, l] = c[t]
            p[k, l] = lo + t

    cps = np.zeros(m, dtype=int)
    if backtrack:
        cur = n
        for k in range(m, 0, -1):
            cps[k - 1] = p[k, cur]
            cur = cps[k - 1]
    scores = I[:, n].copy()
    scores[scores > 1e99] = np.inf
    return cps, scores


def cpd_auto(K: np.ndarray, ncp: int, vmax: float, desc_rate: int = 1, **kw):
    """Auto change-point count via penalized cost (cpd_auto.py:11-54)."""
    m = ncp
    _, scores = cpd_nonlin(K, m, backtrack=False, **kw)
    n = K.shape[0]
    n2 = n * desc_rate
    penalties = np.zeros(m + 1)
    ks = np.arange(1, m + 1)
    penalties[1:] = (vmax * ks / (2.0 * n2)) * (np.log(float(n2) / ks) + 1)
    costs = scores / float(n) + penalties
    m_best = int(np.argmin(costs))
    cps, _ = cpd_nonlin(K, m_best, **kw)
    return cps, costs
