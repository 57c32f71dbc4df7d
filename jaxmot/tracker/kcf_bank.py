"""KCF tracker bank: correlation-only tracking over all live tracks at once.

This is the batched replacement for the reference's per-track
`kcf_init` / `kcf_update` object loop (SURVEY.md §1 L1, §3.2 hot loops 1-2):
one jitted program per frame runs patch extraction → features → detect →
box move → retrain for the whole fixed-capacity bank.  Dead slots ride
along with lr=0 and clamped boxes (masking discipline, SURVEY.md §7(b)).

Also serves standalone as the single-object OTB harness with T=1
(BASELINE.json configs[1]).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxmot.config import KCFConfig
from jaxmot.ops import features as feat_ops
from jaxmot.ops import fft as fft_ops
from jaxmot.ops import kcf as kcf_ops
from jaxmot.ops import patch as patch_ops


class KCFBank(NamedTuple):
    model: kcf_ops.KCFModel   # spectra [T, C, S, Sf] / [T, S, Sf]
    boxes: jnp.ndarray        # [T, 4] (cx, cy, w, h)
    alive: jnp.ndarray        # [T] bool


def _features_at(frame_gray: jnp.ndarray, boxes: jnp.ndarray,
                 cfg: KCFConfig, scales: jnp.ndarray | None = None
                 ) -> jnp.ndarray:
    patches = patch_ops.extract_patches(frame_gray, boxes, cfg.padding,
                                        cfg.template_size, scales)
    return feat_ops.extract_features(patches, cfg)


def init_bank(frame_gray: jnp.ndarray, boxes: jnp.ndarray,
              alive: jnp.ndarray, cfg: KCFConfig) -> KCFBank:
    """Train fresh models on every (alive) slot's box."""
    feats = _features_at(frame_gray, boxes, cfg)
    yf = kcf_ops.make_yf(cfg.feature_size, cfg.padding,
                         cfg.output_sigma_factor)
    model = kcf_ops.train(feats, yf, cfg.kernel_sigma, cfg.lambda_)
    # Zero dead slots so later blends can't leak garbage.
    mask = alive.astype(jnp.float32)
    model = kcf_ops.KCFModel(
        xf=model.xf * mask[:, None, None, None],
        alphaf=model.alphaf * mask[:, None, None])
    return KCFBank(model=model, boxes=boxes, alive=alive)


def detect_bank(bank: KCFBank, frame_gray: jnp.ndarray, cfg: KCFConfig,
                with_aux: bool = False):
    """Correlation response of every live track at its current box.

    Returns (new_boxes [T, 4], peak [T]); with_aux=True appends
    (feats_unit, dy, dx) — the unit-scale features and the chosen
    sub-pixel displacement — for detect-site retraining (step()'s
    train_site="detect").  With cfg.scale_step > 1 a 3-level scale
    pyramid is searched (batched as 3 stacked banks); the best scale
    re-sizes the box, mirroring the C lineage's scale branch.
    """
    s = cfg.feature_size
    t_cap = bank.boxes.shape[0]

    if cfg.scale_step == 1.0:
        feats = _features_at(frame_gray, bank.boxes, cfg)
        feats_unit = feats
        resp = kcf_ops.detect(bank.model, feats, cfg.kernel_sigma)
        dy, dx, peak = kcf_ops.peak_displacement(resp)
        best_scale = jnp.ones_like(peak)
    else:
        # Scales fold into the track axis: one [3T]-batched extract +
        # one broadcast detect (see tracker/step.py for the rationale —
        # the sequential per-scale formulation tripled the critical path).
        step = cfg.scale_step
        scale_vals = jnp.asarray([1.0 / step, 1.0, step], jnp.float32)
        boxes3 = jnp.tile(bank.boxes, (3, 1))          # [3T, 4]
        scales3 = jnp.repeat(scale_vals, t_cap)        # [3T]
        f3 = _features_at(frame_gray, boxes3, cfg, scales3)
        f3 = f3.reshape((3, t_cap) + f3.shape[1:])     # [3, T, C, S, S]
        feats_unit = f3[1]
        r3 = kcf_ops.detect(bank.model, f3, cfg.kernel_sigma)
        dys, dxs, peaks = kcf_ops.peak_displacement(
            r3.reshape(3 * t_cap, s, s))
        dys = dys.reshape(3, t_cap)                    # [3, T]
        dxs = dxs.reshape(3, t_cap)
        peaks = peaks.reshape(3, t_cap)
        w = jnp.asarray([cfg.scale_weight, 1.0, cfg.scale_weight],
                        jnp.float32)[:, None]
        best = jnp.argmax(peaks * w, axis=0)           # [T]
        take = lambda a: jnp.take_along_axis(a, best[None], axis=0)[0]
        dy, dx, peak = take(dys), take(dxs), take(peaks)
        best_scale = scale_vals[best]

    cx, cy, w, h = (bank.boxes[:, 0], bank.boxes[:, 1],
                    bank.boxes[:, 2], bank.boxes[:, 3])
    w = w * best_scale
    h = h * best_scale
    # Displacement is in template pixels of the (scaled) search window.
    cx = cx + dx * w * cfg.padding / s
    cy = cy + dy * h * cfg.padding / s
    new_boxes = jnp.stack([cx, cy, w, h], axis=1)
    new_boxes = jnp.where(bank.alive[:, None], new_boxes, bank.boxes)
    if with_aux:
        return new_boxes, peak, (feats_unit, dy, dx)
    return new_boxes, peak


def train_bank(bank: KCFBank, frame_gray: jnp.ndarray, boxes: jnp.ndarray,
               lr: jnp.ndarray, cfg: KCFConfig) -> KCFBank:
    """EMA-retrain each slot at its (new) box with per-track lr [T]."""
    feats = _features_at(frame_gray, boxes, cfg)
    yf = kcf_ops.make_yf(cfg.feature_size, cfg.padding,
                         cfg.output_sigma_factor)
    new = kcf_ops.train(feats, yf, cfg.kernel_sigma, cfg.lambda_)
    model = kcf_ops.blend(bank.model, new, lr)
    return KCFBank(model=model, boxes=boxes, alive=bank.alive)


@functools.partial(jax.jit, static_argnames=("cfg", "train_site"))
def step(bank: KCFBank, frame_gray: jnp.ndarray, cfg: KCFConfig,
         train_site: str = "refined") -> tuple[KCFBank, jnp.ndarray]:
    """One correlation-tracking frame for the whole bank:
    detect → move boxes → retrain (lr = interp_factor on live slots).

    train_site: "refined" (default — re-extract at the moved boxes, the
    C lineage's shape) or "detect" — retrain on the detect-site spectra
    phase-aligned by the measured sub-pixel displacement
    (ops/kcf.shift_spectrum; same design as tracker/step.py's MOT-level
    train_site="detect", where the A/B methodology and accuracy evidence
    live).  The single-object default stays "refined" because this bank
    is the OTB reference-parity harness (BASELINE configs[1])."""
    if train_site == "detect":
        new_boxes, peak, (feats_unit, dy, dx) = detect_bank(
            bank, frame_gray, cfg, with_aux=True)
        s = cfg.feature_size
        guard = (jnp.abs(dy) < s / 4) & (jnp.abs(dx) < s / 4)
        lr = jnp.where(bank.alive & guard, cfg.interp_factor, 0.0)
        zf = fft_ops.rfft2(feats_unit)
        zf_a = kcf_ops.shift_spectrum(zf, dy, dx, s)
        yf = kcf_ops.make_yf(s, cfg.padding, cfg.output_sigma_factor)
        new = kcf_ops.train_from_spectrum(zf_a, yf, cfg.kernel_sigma,
                                          cfg.lambda_, s)
        model = kcf_ops.blend(bank.model, new, lr)
        return KCFBank(model=model, boxes=new_boxes,
                       alive=bank.alive), peak
    new_boxes, peak = detect_bank(bank, frame_gray, cfg)
    lr = jnp.where(bank.alive, cfg.interp_factor, 0.0)
    new_bank = train_bank(bank, frame_gray, new_boxes, lr, cfg)
    return new_bank, peak


@functools.partial(jax.jit, static_argnames=("cfg", "train_site"))
def run_otb_sequence(bank: KCFBank, frames: jnp.ndarray, cfg: KCFConfig,
                     train_site: str = "refined"
                     ) -> tuple[KCFBank, jnp.ndarray, jnp.ndarray]:
    """Track a whole clip in ONE device program (lax.scan over frames) —
    the throughput shape of the single-object OTB flow (SURVEY.md §3.3):
    the per-frame KCFTracker.update pays a host↔device round trip per
    frame; this pays one per clip.

    frames: [N, H, W] (or [N, H, W, 3]); returns (final bank,
    boxes [N, T, 4], peaks [N, T]).
    """
    def body(b, frame):
        b2, peak = step(b, patch_ops.to_gray(frame), cfg, train_site)
        return b2, (b2.boxes, peak)

    bank, (boxes, peaks) = jax.lax.scan(body, bank, frames)
    return bank, boxes, peaks


class KCFTracker:
    """Single-object convenience wrapper — the reference's `kcf_init` /
    `kcf_update` API (SURVEY.md §3.3, OTB harness)."""

    def __init__(self, cfg: KCFConfig | None = None):
        self.cfg = cfg or KCFConfig()
        self.bank: KCFBank | None = None

    def init(self, frame, box) -> None:
        gray = patch_ops.to_gray(jnp.asarray(frame))
        boxes = jnp.asarray(box, jnp.float32)[None]
        self.bank = init_bank(gray, boxes, jnp.ones((1,), bool), self.cfg)

    def update(self, frame):
        gray = patch_ops.to_gray(jnp.asarray(frame))
        self.bank, peak = step(self.bank, gray, self.cfg)
        import numpy as np
        return np.asarray(self.bank.boxes[0]), float(peak[0])
