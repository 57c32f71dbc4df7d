"""Vectorized Felzenszwalb HOG (fHOG) features for the correlation filter.

The KCF lineage's strong-feature mode (arXiv:1404.7584 §8 "HOG" rows;
SURVEY.md §2 row "features": "fhog as vectorized JAX if parity requires").
The reference computes fHOG per track in C; here the whole [T, P, P] patch
bank is transformed at once with pure tensor ops:

  gradients → signed-orientation soft binning (18 bins) → cell pooling →
  4-neighborhood block normalization (truncated at 0.2) → 31 channels
  (18 contrast-sensitive + 9 contrast-insensitive + 4 texture energy),
  per Felzenszwalb et al., PAMI 2010 §6.1.

Output: [T, 31, P/cell, P/cell], ready for the multi-channel KCF core.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

N_BINS = 18           # signed orientation bins
EPS = 1e-7
TRUNC = 0.2


def hog_features(patches: jnp.ndarray, cell: int = 4) -> jnp.ndarray:
    """[T, P, P] grayscale patches in [0, 1] → fHOG [T, 31, F, F]."""
    t, p, _ = patches.shape
    f = p // cell
    x = patches

    # Central-difference gradients with edge replication.
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1)), mode="edge")
    dy = 0.5 * (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1])
    dx = 0.5 * (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2])
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)                     # [-pi, pi)

    # Soft assignment to the two nearest signed bins, as a periodic hat
    # function with the BIN axis leading.  Rather than a one-hot gather
    # (jnp.eye(18)[b0] at [T, P, P, 18]: integer gathers and an 18-wide
    # minor axis at pixel resolution), this broadcast-compare form is
    # pure elementwise work with the pixel axis kept minor.
    pos = (ang + np.pi) / (2.0 * np.pi) * N_BINS  # [0, 18)
    bins = jnp.arange(N_BINS, dtype=jnp.float32).reshape(N_BINS, 1, 1, 1)
    d = jnp.abs(pos[None] - bins)                 # [18, T, P, P]
    d = jnp.minimum(d, N_BINS - d)                # periodic bin distance
    votes = jnp.maximum(0.0, 1.0 - d) * mag[None]

    # Cell pooling (sum over cell x cell blocks), then bins to the minor
    # axis for the (small) [T, F, F, 18] normalization stage.
    hist = votes.reshape(N_BINS, t, f, cell, f, cell).sum(axis=(3, 5))
    hist = jnp.transpose(hist, (1, 2, 3, 0))      # [T, F, F, 18]

    # Contrast-insensitive 9-bin histogram.
    insens = hist[..., :9] + hist[..., 9:]                 # [T, F, F, 9]

    # Block energies: sums of squared insensitive bins over 2x2 cell
    # neighborhoods (the 4 diagonal blocks around each cell).
    energy = jnp.sum(insens * insens, axis=-1)             # [T, F, F]
    ep = jnp.pad(energy, ((0, 0), (1, 1), (1, 1)), mode="edge")
    n00 = ep[:, :-2, :-2] + ep[:, :-2, 1:-1] + ep[:, 1:-1, :-2] \
        + ep[:, 1:-1, 1:-1]
    n01 = ep[:, :-2, 1:-1] + ep[:, :-2, 2:] + ep[:, 1:-1, 1:-1] \
        + ep[:, 1:-1, 2:]
    n10 = ep[:, 1:-1, :-2] + ep[:, 1:-1, 1:-1] + ep[:, 2:, :-2] \
        + ep[:, 2:, 1:-1]
    n11 = ep[:, 1:-1, 1:-1] + ep[:, 1:-1, 2:] + ep[:, 2:, 1:-1] \
        + ep[:, 2:, 2:]
    inv = [1.0 / jnp.sqrt(n + EPS)[..., None] for n in (n00, n01, n10, n11)]

    # Contrast-sensitive (18) and insensitive (9) channels: average of the
    # four truncated normalizations.
    def norm_avg(v):
        return 0.25 * sum(jnp.minimum(v * i, TRUNC) for i in inv)

    sens = norm_avg(hist)                                  # [T, F, F, 18]
    insens_n = norm_avg(insens)                            # [T, F, F, 9]
    # Texture-energy features: per-neighborhood total of truncated
    # sensitive contributions (Felzenszwalb's 4 extra dims).
    tex = jnp.stack(
        [0.2357 * jnp.sum(jnp.minimum(hist * i, TRUNC), axis=-1)
         for i in inv], axis=-1)                           # [T, F, F, 4]

    out = jnp.concatenate([sens, insens_n, tex], axis=-1)  # [T, F, F, 31]
    return jnp.transpose(out, (0, 3, 1, 2)).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def n_channels() -> int:
    return N_BINS + 9 + 4
