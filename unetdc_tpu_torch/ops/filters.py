"""Separable Gaussian filters on the last two dims; port of the JAX
package's `ops/filters.py`.

- `gaussian_filter_scipy`: scipy.ndimage.gaussian_filter (mode 'reflect',
  truncate 4), as training augmentation uses it (one matmul per pass).
- `gaussian_derivative_scipy`: scipy.ndimage.gaussian_filter with an
  order per axis (mode 'reflect'), the blob detectors' LoG, DoG and
  Hessian filters, with the rounding of `separable_taps` below.
- `gaussian_blur`: cv2.GaussianBlur (BORDER_REFLECT_101) of the heatmap
  ROI, and `separable_taps`, the tap-by-tap filter the heatmaps use, with
  the JAX package's rounding: the JAX filter is a chain
  `k0*x0 + k1*x1 + ... + k(n-1)*x(n-1)` that XLA on the CPU compiles to
  fused multiply-adds (the first product fused into the first add, every
  later product fused into the running sum). Each fused step is
  `round_f32(acc + k*x)` with the product exact, which the port computes
  in float64 (the product of two floats is exact there) and rounds once:
  the same bits on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from unetdc_tpu_torch.utils.profiling import sync


def cv2_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: if sigma <= 0, sigma = 0.3*((ksize-1)*0.5-1)
    + 0.8, as the JAX package computes it."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _reflect101_index(n: int, r: int) -> np.ndarray:
    """Source index of each position in [-r, n + r) under BORDER_REFLECT_101
    (numpy 'reflect': the edge sample not repeated); needs r < n."""
    i = np.abs(np.arange(-r, n + r))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _fma_chain(terms, taps: np.ndarray) -> torch.Tensor:
    """sum_i taps[i] * terms(i) with the JAX package's CPU rounding (module
    docstring): acc = round(k0*x0 + round(k1*x1)), then
    acc = round(acc + k_i*x_i) for i >= 2, each sum taken in float64 on the
    exact product."""
    k = [float(v) for v in np.asarray(taps, np.float32)]
    x1 = terms(1)
    acc = (terms(0).double() * k[0] + (x1 * k[1]).double()).float()
    for i in range(2, len(k)):
        acc = (acc.double() + terms(i).double() * k[i]).float()
    return acc


def separable_taps(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray,
                   reflect101: bool) -> torch.Tensor:
    """Correlate the last two dims with taps `ky` (rows) then `kx`
    (columns), float32, with the edges extended by REFLECT_101 (cv2) or by
    'reflect' (scipy); the JAX package's `_separable` to the bit."""
    ry, rx = len(ky) // 2, len(kx) // 2
    h, w = img.shape[-2:]
    index = _reflect101_index if reflect101 else _symmetric_index
    dev = img.device
    x = img.to(torch.float32)
    x = x.index_select(-2, torch.from_numpy(index(h, ry)).to(dev))
    x = x.index_select(-1, torch.from_numpy(index(w, rx)).to(dev))
    rows = _fma_chain(lambda i: x[..., i:i + h, :], ky)
    return _fma_chain(lambda j: rows[..., :, j:j + w], kx)


def gaussian_blur(img: torch.Tensor, ksize: int = 15, sigma: float = 0.0
                  ) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) over the last two dims,
    float32 out (callers round for uint8), border REFLECT_101."""
    k = cv2_gaussian_kernel(ksize, sigma)
    return separable_taps(img, k, k, reflect101=True)


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
    with sync("filter_taps", 2):  # two blocking uploads
        idx = torch.from_numpy(_symmetric_index(n, r)).to(x.device)
        taps = torch.from_numpy(k).to(x.device, x.dtype)
    xp = x.index_select(-1, idx)                      # (..., n + 2r)
    win = xp.unfold(-1, len(k), 1)                    # (..., n, K)
    return win @ taps


def gaussian_filter_scipy(img: torch.Tensor, sigma: float,
                          truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(img, sigma) over the last two dims
    (mode 'reflect'), float32; rows first, then columns, as the JAX
    package's separable filter does."""
    k = scipy_gaussian_kernel(sigma, truncate)
    x = img.to(torch.float32)
    x = _correlate_last(x.transpose(-1, -2), k).transpose(-1, -2)
    return _correlate_last(x, k)


def gaussian_derivative_scipy(img: torch.Tensor, sigma: float, order_y: int,
                              order_x: int, truncate: float = 4.0
                              ) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(img, sigma, order=(order_y, order_x),
    mode='reflect') over the last two dims, float32: the separable
    Gaussian-derivative taps applied as the JAX package's `_separable`
    applies them (`separable_taps`), so the sums round as there."""
    ky = scipy_gaussian_kernel(sigma, truncate, order_y)
    kx = scipy_gaussian_kernel(sigma, truncate, order_x)
    return separable_taps(img, ky, kx, reflect101=False)
