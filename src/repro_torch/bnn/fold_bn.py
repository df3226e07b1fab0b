"""Fold batch-norm + sign into integer thresholds (Sari et al. 2019,
as used by the paper's step layers).

For integer pre-activation y:
    sign(gamma * (y - mean) / sqrt(var + eps) + beta) == +1
        gamma > 0:  y >= t  where t = mean - beta * sqrt(var+eps) / gamma
                    <=> y > ceil(t) - 1          (strict int compare)
        gamma < 0:  y <= t  <=> not (y > floor(t))
        gamma == 0: constant sign(beta)  (beta >= 0 -> +1)

The packed step layer computes ``bit = (y > T) ^ flip``.  Pure NumPy: the
port keeps its own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.bnn.layers import BN_EPS

_BIG = np.int32(2**30)


def fold_bn(
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = BN_EPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Return per-channel (threshold int32, flip bool)."""
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    sd = np.sqrt(var + eps)

    with np.errstate(divide="ignore", invalid="ignore"):
        t = mean - beta * sd / gamma

    thresh = np.empty(gamma.shape, np.int64)
    flip = np.zeros(gamma.shape, bool)

    pos = gamma > 0
    neg = gamma < 0
    zero = gamma == 0

    thresh[pos] = np.ceil(t[pos]).astype(np.int64) - 1
    thresh[neg] = np.floor(t[neg]).astype(np.int64)
    flip[neg] = True
    # gamma == 0: output is constant sign(beta); beta >= 0 -> always fire
    bz = beta[zero] >= 0
    thresh[zero] = np.where(bz, -_BIG, _BIG)

    return np.clip(thresh, -_BIG, _BIG).astype(np.int32), flip
