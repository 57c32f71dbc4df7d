"""Patch → feature maps for the correlation filter.

Reference: L1 feature extraction (SURVEY.md §2 row "features") — raw
grayscale features normalized to [-0.5, 0.5] and cosine-windowed
(arXiv:1404.7584 §8, "raw pixels" configuration).  The hook for
multi-channel (HOG-family) features is the channel axis: everything
downstream is already batched over [T, C, S, S].
"""

from __future__ import annotations

import jax.numpy as jnp

from jaxmot.config import KCFConfig
from jaxmot.ops import window as window_ops


def raw_gray_features(patches: jnp.ndarray) -> jnp.ndarray:
    """[T, S, S] patches in [0, 1] → windowed features [T, 1, S, S].

    Zero-centering (x - 0.5) before the cosine window keeps the circulant
    boundary at ~0, per the KCF raw-pixel recipe."""
    s = patches.shape[-1]
    hann = window_ops.hann2d(s, s)
    feat = (patches - 0.5) * hann
    return feat[:, None, :, :]


def extract_features(patches: jnp.ndarray, cfg: KCFConfig) -> jnp.ndarray:
    """Patch bank [T, P, P] → cosine-windowed features [T, C, F, F]
    per cfg.feature_type ("gray": C=1 F=P; "hog": C=31 F=P/cell)."""
    if cfg.feature_type == "hog":
        from jaxmot.ops import hog
        feat = hog.hog_features(patches, cfg.cell_size)    # [T, 31, F, F]
        f = feat.shape[-1]
        return feat * window_ops.hann2d(f, f)[None, None]
    return raw_gray_features(patches)
