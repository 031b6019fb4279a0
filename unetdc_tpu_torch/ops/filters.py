"""scipy.ndimage.gaussian_filter semantics (mode 'reflect', truncate 4) on
the last two dims; port of the part of the JAX package's `ops/filters.py`
that training augmentation needs (`scipy_gaussian_kernel`,
`gaussian_filter_scipy`)."""

from __future__ import annotations

import numpy as np
import torch


def scipy_gaussian_kernel(sigma: float, truncate: float = 4.0,
                          order: int = 0) -> np.ndarray:
    """scipy.ndimage's `_gaussian_kernel1d(sigma, order, radius)` with
    radius = int(truncate*sigma + 0.5), REVERSED for use as a correlation
    tap list (scipy convolves with the unreversed kernel; for even orders
    the reversal is a no-op). order 0 = normalized Gaussian; order n = n-th
    Gaussian derivative via the Hermite-recurrence polynomial q(x)*phi(x)."""
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) ** 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi = phi / phi.sum()
    if order > 0:
        expo = np.arange(order + 1)
        q = np.zeros(order + 1)
        q[0] = 1
        D = np.diag(expo[1:].astype(np.float64), 1)   # q -> q'
        P = np.diag(np.ones(order) / -sigma2, -1)     # q -> q * p'
        for _ in range(order):
            q = (D + P).dot(q)
        phi = (x[:, None] ** expo).dot(q) * phi
    return phi[::-1].astype(np.float32)


def _symmetric_index(n: int, r: int) -> np.ndarray:
    """Source index of each position in [-r, n + r) under scipy's 'reflect'
    (numpy 'symmetric': the edge sample repeated), for pads of any width:
    the extension is periodic with period 2n."""
    i = np.arange(-r, n + r) % (2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def _correlate_last(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Correlate the last dim with taps `k` (odd length), reflect edges."""
    r = len(k) // 2
    n = x.shape[-1]
    idx = torch.from_numpy(_symmetric_index(n, r)).to(x.device)
    xp = x.index_select(-1, idx)                      # (..., n + 2r)
    win = xp.unfold(-1, len(k), 1)                    # (..., n, K)
    return win @ torch.from_numpy(k).to(x.device, x.dtype)


def gaussian_filter_scipy(img: torch.Tensor, sigma: float,
                          truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(img, sigma) over the last two dims
    (mode 'reflect'), float32; rows first, then columns, as the JAX
    package's separable filter does."""
    k = scipy_gaussian_kernel(sigma, truncate)
    x = img.to(torch.float32)
    x = _correlate_last(x.transpose(-1, -2), k).transpose(-1, -2)
    return _correlate_last(x, k)
