"""Windowing and target-response constants for the KCF core.

Equivalents of the reference's L0 constants (SURVEY.md §2 rows
"coswindow" and "gaussian_target"): both are shape-static, so they are built
once at trace time and folded into the compiled program as literals — the
reference computes them once at tracker construction.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def hann2d(height: int, width: int) -> jnp.ndarray:
    """2-D Hann (cosine) window (NumPy constant; folded in at trace time).

    Applied to features before the FFT to suppress boundary discontinuities
    of the circulant model (arXiv:1404.7584 §4.1, "cosine window").
    """
    if height < 2 or width < 2:
        raise ValueError(f"hann2d needs sizes >= 2, got {height}x{width} "
                         "(KCFConfig.__post_init__ rejects such configs)")
    hy = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(height) / (height - 1)))
    hx = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(width) / (width - 1)))
    return np.outer(hy, hx).astype(np.float32)


@functools.lru_cache(maxsize=None)
def gaussian_peak(height: int, width: int, sigma: float) -> jnp.ndarray:
    """Desired response y: 2-D Gaussian with peak at the patch center.

    The regression target of KCF training (arXiv:1404.7584 §5.2).  Peak at
    (height // 2, width // 2); a detect displacement is therefore
    argmax(response) - center.
    """
    cy, cx = height // 2, width // 2
    yy = (np.arange(height) - cy) ** 2
    xx = (np.arange(width) - cx) ** 2
    g = np.exp(-0.5 * (yy[:, None] + xx[None, :]) / (sigma * sigma))
    return g.astype(np.float32)


def output_sigma(height: int, width: int, padding: float,
                 output_sigma_factor: float) -> float:
    """Bandwidth of the desired response, scaled to the target (unpadded)
    extent inside the template: sqrt(h*w) / padding * factor."""
    return float(np.sqrt(height * width) / padding * output_sigma_factor)
