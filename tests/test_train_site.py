"""Detect-site KCF training (cfg.train_site="detect"): Fourier-aligned
reuse of the detection patch spectra replaces the second per-frame ROI
extraction (config.py train_site docstring; SURVEY.md §3.2 hot loop 3 —
the retrain extraction is the reference's third hot loop, eliminated
here by the shift theorem instead of ported).

Covers: the shift_spectrum primitive vs jnp.roll, alphaf's phase
invariance, MOTA parity with the refined-site default on the standard
scene AND on the model-quality-sensitive detector-outage fixture, and
the mass-birth (frame-0) deferred-init path.
"""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.ops import fft as fft_ops
from jaxmot.ops import kcf as kcf_ops
from jaxmot.utils import metrics

from test_tracker import _make_scene, _run_ours


def test_shift_spectrum_matches_roll():
    """Integer shifts: shift_spectrum(rfft2(x), dy, dx) == rfft2 of the
    circularly rolled x (the Fourier shift theorem, exactly — float
    noise only)."""
    rng = np.random.default_rng(0)
    x = rng.random((3, 2, 16, 16)).astype(np.float32)     # [T, C, S, S]
    xf = fft_ops.rfft2(jnp.asarray(x))
    for dy, dx in [(1, 0), (0, 1), (-2, 3), (5, -4)]:
        shifted = kcf_ops.shift_spectrum(
            xf, jnp.full((3,), float(dy)), jnp.full((3,), float(dx)), 16)
        # f(n + d)  ==  np.roll(f, -d)
        ref = fft_ops.rfft2(jnp.asarray(
            np.roll(x, (-dy, -dx), axis=(-2, -1))))
        np.testing.assert_allclose(np.asarray(shifted.re),
                                   np.asarray(ref.re), atol=1e-4)
        np.testing.assert_allclose(np.asarray(shifted.im),
                                   np.asarray(ref.im), atol=1e-4)


def test_shift_spectrum_subpixel_roundtrip():
    """A +d then -d fractional shift must return the original spectrum
    (the phases cancel exactly; sinc interpolation is invertible)."""
    rng = np.random.default_rng(1)
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    xf = fft_ops.rfft2(jnp.asarray(x))
    d_y = jnp.asarray([0.3, -1.7])
    d_x = jnp.asarray([2.5, 0.1])
    back = kcf_ops.shift_spectrum(
        kcf_ops.shift_spectrum(xf, d_y, d_x, 16), -d_y, -d_x, 16)
    np.testing.assert_allclose(np.asarray(back.re), np.asarray(xf.re),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(back.im), np.asarray(xf.im),
                               atol=1e-5)


def test_alphaf_invariant_under_shift():
    """k^xx depends only on |X| — alphaf from the aligned spectrum must
    equal alphaf from the raw one; only the template xf carries phase
    (ops/kcf.train_from_spectrum docstring)."""
    rng = np.random.default_rng(2)
    feat = jnp.asarray(rng.random((4, 2, 32, 32)).astype(np.float32))
    yf = kcf_ops.make_yf(32, 1.5, 0.125)
    base = kcf_ops.train(feat, yf, sigma=0.5, lambda_=1e-4)
    zf = fft_ops.rfft2(feat)
    zf_a = kcf_ops.shift_spectrum(zf, jnp.asarray([0.5, -1.2, 3.0, 0.0]),
                                  jnp.asarray([1.1, 0.0, -2.5, 4.2]), 32)
    shifted = kcf_ops.train_from_spectrum(zf_a, yf, 0.5, 1e-4, 32)
    # The identity is exact in exact arithmetic, but alphaf = yf/(kf+λ)
    # divides by near-λ denominators: float32's ~6e-5 kf noise (measured)
    # is amplified by 1/(kf+λ) wherever kf ≈ 0, so the comparison must
    # be relative to alphaf's own scale, not absolute.
    scale = np.abs(np.asarray(base.alphaf.re)).max()
    np.testing.assert_allclose(np.asarray(shifted.alphaf.re),
                               np.asarray(base.alphaf.re),
                               atol=2e-3 * scale)
    np.testing.assert_allclose(np.asarray(shifted.alphaf.im),
                               np.asarray(base.alphaf.im),
                               atol=2e-3 * scale)


def test_detect_site_mota_parity():
    """Standard noisy-detections scene: detect-site training must match
    the refined-site default to within noise on MOTA/IDF1."""
    frames, dets, gt = _make_scene()
    kw = dict(frame_height=240, frame_width=320)
    m_ref = metrics.clear_mot(gt, _run_ours(
        frames, dets, TrackerConfig(**kw))[0])
    m_det = metrics.clear_mot(gt, _run_ours(
        frames, dets, TrackerConfig(train_site="detect", **kw))[0])
    assert m_ref["mota"] > 0.75, m_ref
    assert m_det["mota"] >= m_ref["mota"] - 0.03, (m_det, m_ref)
    assert m_det["idf1"] >= m_ref["idf1"] - 0.05, (m_det, m_ref)


def test_detect_site_survives_detector_outage():
    """The fixture where MODEL QUALITY actually matters: a 20-frame
    detector outage across direction changes — tracking then rides
    entirely on the KCF models trained before/during the outage.  The
    detect-site-trained models must coast as well as refined-site ones
    (and far better than SORT, which this fixture exists to show)."""
    objs = [
        synthetic.SyntheticObject(cx=40, cy=60, w=26, h=26, vx=-4.0,
                                  vy=1.0),
        synthetic.SyntheticObject(cx=280, cy=180, w=28, h=24, vx=4.0,
                                  vy=-1.0),
        synthetic.SyntheticObject(cx=160, cy=30, w=24, h=28, vx=1.0,
                                  vy=-4.0),
    ]
    n_frames = 45
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, 240, 320, seed=7)
    dets = synthetic.detections_from_gt(boxes, vis, seed=7,
                                        frame_hw=(240, 320))
    for f in range(12, 32):
        dets[f] = np.zeros((0, 5), np.float32)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    kw = dict(frame_height=240, frame_width=320, n_init=2, min_psr=0.15)
    m_ref = metrics.clear_mot(gt, _run_ours(
        frames, dets, TrackerConfig(**kw))[0])
    m_det = metrics.clear_mot(gt, _run_ours(
        frames, dets, TrackerConfig(train_site="detect", **kw))[0])
    assert m_ref["mota"] > 0.5, m_ref
    assert m_det["mota"] >= m_ref["mota"] - 0.05, (m_det, m_ref)


def test_detect_site_mass_birth():
    """Frame-0 mass birth (the bench shape: an empty bank meets a full
    scene).  All births defer model init to their first post-birth frame
    (lr=1 aligned overwrite); tracking must come up to full MOTA — the
    one-frame KCF gate must not cost confirmations."""
    frames, dets, gt = _make_scene(n_obj=24, n_frames=20, seed=3)
    cfg = TrackerConfig(train_site="detect", frame_height=240,
                        frame_width=320)
    hyp, mt = _run_ours(frames, dets, cfg)
    m = metrics.clear_mot(gt, hyp)
    assert m["mota"] > 0.7, m
    assert mt.counters()["alive"] >= 20
