"""Vmapped constant-velocity Kalman filter over the track state bank.

Batched replacement of the reference's per-track hand-rolled small-matrix
KF (SURVEY.md §2 row "kalman"): the whole bank's predict/correct is two
batched einsum programs over [T, 8] means and [T, 8, 8] covariances — the
"vmapped small-matrix ops over the track state bank" named by the
BASELINE.json north star.

State: [cx, cy, w, h, vcx, vcy, vw, vh]; measurement: [cx, cy, w, h].
Noise scales follow the SORT/DeepSORT lineage: stds proportional to box
size, so large targets tolerate proportionally larger residuals.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jaxmot.config import KalmanConfig

# All KF matmuls run at HIGHEST precision.  A DEFAULT-precision f32 dot
# may round its operands to a short mantissa (TF32 keeps 10 bits, bf16
# 8): at 1080p coordinates (x up to 1920) that is a pixel-scale quantum
# injected into every predict/correct, enough to swap identities on the
# class-aware bounce fixture.  The [T, 8, 8] operands are tiny, so the
# full-precision product costs next to nothing.
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

_DIM = 8
_F = np.eye(_DIM, dtype=np.float32)
_F[:4, 4:] = np.eye(4, dtype=np.float32)       # x += v * dt (dt = 1 frame)
_H = np.eye(4, _DIM, dtype=np.float32)


def init(boxes: jnp.ndarray, cfg: KalmanConfig
         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Initialize bank state from measured boxes [T, 4].

    Returns (mean [T, 8], cov [T, 8, 8]). Velocity prior is wide
    (uninformative) — matches the SORT lineage's fresh-track covariance."""
    t = boxes.shape[0]
    mean = jnp.concatenate([boxes, jnp.zeros((t, 4), jnp.float32)], axis=1)
    scale = jnp.maximum(jnp.maximum(boxes[:, 2], boxes[:, 3]), 1.0)
    pos_var = (2.0 * cfg.pos_std_factor * scale) ** 2            # [T]
    diag = jnp.concatenate([
        jnp.tile(pos_var[:, None], (1, 4)),
        jnp.full((t, 4), cfg.init_vel_cov, jnp.float32)], axis=1)
    cov = jnp.eye(_DIM, dtype=jnp.float32)[None] * diag[:, None, :]
    return mean, cov


def predict(mean: jnp.ndarray, cov: jnp.ndarray, cfg: KalmanConfig
            ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """x' = F x ; P' = F P F^T + Q(scale). Batched over the bank."""
    f = jnp.asarray(_F)
    scale = jnp.maximum(jnp.maximum(mean[:, 2], mean[:, 3]), 1.0)
    q_pos = (cfg.process_pos_std * scale) ** 2
    q_vel = (cfg.process_vel_std * scale) ** 2
    q_diag = jnp.concatenate([jnp.tile(q_pos[:, None], (1, 4)),
                              jnp.tile(q_vel[:, None], (1, 4))], axis=1)
    new_mean = _einsum("ij,tj->ti", f, mean)
    new_cov = (_einsum("ij,tjk,lk->til", f, cov, f)
               + jnp.eye(_DIM, dtype=jnp.float32)[None] * q_diag[:, None, :])
    return new_mean, new_cov


def _inv2x2(m: jnp.ndarray) -> jnp.ndarray:
    """Batched 2x2 inverse [..., 2, 2] (elementwise)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    row0 = jnp.stack([d, -b], axis=-1)
    row1 = jnp.stack([-c, a], axis=-1)
    return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]


def _inv4x4_spd(s: jnp.ndarray) -> jnp.ndarray:
    """Batched 4x4 inverse of symmetric positive-definite matrices via
    2x2-block Schur complement — pure VPU elementwise math, no custom
    calls.  s: [..., 4, 4]."""
    a = s[..., :2, :2]
    b = s[..., :2, 2:]
    c = s[..., 2:, :2]
    d = s[..., 2:, 2:]
    ai = _inv2x2(a)
    aib = _mm(ai, b)                                 # [..., 2, 2]
    schur = d - _mm(c, aib)
    si = _inv2x2(schur)
    cai = _mm(c, ai)
    top_left = ai + _mm(_mm(aib, si), cai)
    top_right = -_mm(aib, si)
    bot_left = -_mm(si, cai)
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def correct(mean: jnp.ndarray, cov: jnp.ndarray, z: jnp.ndarray,
            gate: jnp.ndarray, cfg: KalmanConfig
            ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Measurement update with per-track gate mask [T] (False = no-op slot).

    The gate replaces the reference's per-track 'if matched' branch: the
    whole bank runs one batched update and unmatched slots keep their
    predicted state — compiler-friendly control flow."""
    h = jnp.asarray(_H)
    scale = jnp.maximum(jnp.maximum(mean[:, 2], mean[:, 3]), 1.0)
    r_diag = ((cfg.pos_std_factor * scale) ** 2)[:, None] * jnp.ones(
        (1, 4), jnp.float32)                                       # [T, 4]
    s = (_einsum("ij,tjk,lk->til", h, cov, h)
         + jnp.eye(4, dtype=jnp.float32)[None] * r_diag[:, None, :])
    pht = _einsum("tjk,ik->tji", cov, h)                        # [T, 8, 4]
    # K = P H^T S^-1 with a closed-form batched 4x4 inverse: linalg.solve
    # lowers to a batched LU custom call; S is symmetric positive
    # definite, so a 2x2-block Schur inverse is a handful of elementwise
    # ops instead.
    k = _einsum("tji,tik->tjk", pht, _inv4x4_spd(s))            # [T,8,4]
    resid = z - _einsum("ij,tj->ti", h, mean)                   # [T, 4]
    new_mean = mean + _einsum("tij,tj->ti", k, resid)
    kh = _einsum("tij,jk->tik", k, h)                           # [T,8,8]
    new_cov = _einsum("tij,tjk->tik", jnp.eye(_DIM)[None] - kh, cov)
    g = gate[:, None]
    return (jnp.where(g, new_mean, mean),
            jnp.where(g[:, :, None], new_cov, cov))
