"""Training losses and image metrics.

Counterpart of dgmesh_tpu/ops/losses.py (reference utils/loss_utils.py,
utils/image_utils.py:19-27, and an MS-SSIM in place of pytorch_msssim).
SSIM uses the reference's 11-tap σ=1.5 separable Gaussian window with SAME
(zero) padding and C1=0.01², C2=0.03², as a depthwise ``conv2d``.  TF32
stays off (``device.set_precision``): the f(x²)−μ² variance cancellation
needs full float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error; ``torch.abs`` has gradient 0 at 0, as the JAX
    version's d·sign(d) does (it matters for the straight-through mask)."""
    return (x - y).abs().mean()


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = ((img - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def _gaussian_window(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=like.device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_separable(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable 2D filter with SAME zero padding; img (C,H,W)."""
    c, k = img.shape[0], win.shape[0]
    x = img[None]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).repeat(c, 1, 1, 1), padding=(k // 2, 0), groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, k).repeat(c, 1, 1, 1), padding=(0, k // 2), groups=c)
    return x[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, full: bool = False):
    """Windowed SSIM over (C,H,W) images in [0,1] (reference loss_utils.py:45-76).
    With ``full``, also the mean contrast-structure term."""
    win = _gaussian_window(window_size, sigma, img1)

    def f(x):
        return _filter2d_separable(x, win)

    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f(img1 * img1) - mu1_sq
    sigma2_sq = f(img2 * img2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if full:
        cs = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
        return ssim_map.mean(), cs.mean()
    return ssim_map.mean()


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
            sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM over (C,H,W) images, 2×2 average pooling between
    the five scales (replaces pytorch_msssim, reference train.py:653-672)."""
    zero = img1.new_zeros(())
    mcs, x, y, val = [], img1, img2, None
    for i in range(len(_MSSSIM_WEIGHTS)):
        s, cs = ssim(x, y, window_size, sigma, full=True)
        if i < len(_MSSSIM_WEIGHTS) - 1:
            mcs.append(torch.maximum(cs, zero))
            x = F.avg_pool2d(x[None], 2)[0]
            y = F.avg_pool2d(y[None], 2)[0]
        else:
            val = torch.maximum(s, zero)
    out = val ** _MSSSIM_WEIGHTS[-1]
    for w, cs in zip(_MSSSIM_WEIGHTS[:-1], mcs):
        out = out * cs ** w
    return out


def image_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1−λ)·L1 + λ·(1−SSIM), for the GS and the mesh images
    (reference train.py:270-276, 306-312)."""
    return (1.0 - lambda_dssim) * l1_loss(img, gt) + lambda_dssim * (1.0 - ssim(img, gt))
