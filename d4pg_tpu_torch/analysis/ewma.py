"""Vectorized exponentially-weighted moving average.

Parity: the original implementation's smoothing in
``plots/plots.py:6-21`` (vectorized EWMA with bias-corrected warmup) and
the 0.95/0.05 online tracking at ``main.py:131, 346``.
"""

from __future__ import annotations

import numpy as np


def ewma(x: np.ndarray, alpha: float = 0.95) -> np.ndarray:
    """Bias-corrected EWMA: y_t = (1-a) * sum_k a^k x_{t-k} / (1 - a^{t+1}).

    Matches the original implementation's formulation (scaling factors +
    cumulative offset, ``plots/plots.py:8-21``) without its O(T^2)
    scaling-matrix construction for long series.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n == 0:
        return x.astype(np.float64)
    # recursive form, numerically robust for long series
    out = np.empty(n, np.float64)
    acc = 0.0
    for t in range(n):
        acc = alpha * acc + (1.0 - alpha) * x[t]
        out[t] = acc / (1.0 - alpha ** (t + 1))
    return out
