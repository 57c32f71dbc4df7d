"""Per-scale forward-precision routing (r5, tracker/step.py step 2):
under train_site="detect" only the UNIT-scale feature spectrum feeds
train()'s spectral divide, so the off-scale spectra must ride the cheap
response (inverse) precision class, and the divide-class unit spectrum
must be computed ONCE and reused by step 8 (no second [T] forward).

Spies on ops.fft.rfft2 at trace time (configs are jit statics; the
traced-Python wrapper records every transform's shape + class).  CPU
numerics are class-independent, so goldens/tracking parity is covered
elsewhere — this pins the WIRING that saves the off-scale spectra the
divide-class precision.
"""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import KCFConfig, TrackerConfig
from jaxmot.data import synthetic
from jaxmot.ops import fft as fft_ops
from jaxmot.tracker import bank as bank_mod
from jaxmot.tracker import step as step_mod
from jaxmot.tracker.api import pad_detections


def _trace_step(monkeypatch, **cfg_kw):
    """Run one traced step under a spy; return [(lead_shape, response_class)]
    for every rfft2 whose operand is a feature stack ([..., C, S, S])."""
    calls = []
    orig = fft_ops.rfft2

    def spy(x, backend=None, response_class=False):
        calls.append((tuple(x.shape), bool(response_class)))
        return orig(x, backend, response_class=response_class)

    monkeypatch.setattr(step_mod.fft_ops, "rfft2", spy)
    step_mod.step.clear_cache()

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(3, 96, 128, rng, min_size=14,
                                  max_size=24, max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, 3, 96, 128, seed=1)
    cfg = TrackerConfig(max_tracks=4, max_detections=4, frame_height=96,
                        frame_width=128, n_init=1, **cfg_kw)
    bank = bank_mod.empty_bank(cfg)
    for f in range(3):
        d, v = pad_detections(
            synthetic.detections_from_gt(boxes, vis, seed=1,
                                         frame_hw=(96, 128))[f], 4)
        bank, _ = step_mod.step(bank, jnp.asarray(
            (frames[f] * 255).astype(np.uint8)), jnp.asarray(d),
            jnp.asarray(v), cfg)
    step_mod.step.clear_cache()
    monkeypatch.setattr(step_mod.fft_ops, "rfft2", orig)
    s = cfg.kcf.template_size
    # Feature-stack transforms only: [..., C=1, S, S] for gray features.
    # (The k-spectrum transforms inside gaussian_correlation are
    # [..., T, S, S] — channel axis T=4 here — and are pinned separately
    # by test_fft.test_detect_response_only_wiring.)
    return [(c, rc) for c, rc in calls
            if len(c) >= 4 and c[-1] == s and c[-2] == s and c[-3] == 1]


def test_multiscale_detect_site_routing(monkeypatch):
    """3-scale + train_site=detect: ONE divide-class [T,C,S,S] forward
    (unit scale, reused by train — so exactly one per traced step) and
    ONE response-class [2,T,C,S,S] batch for the off scales."""
    feats = _trace_step(monkeypatch, train_site="detect",
                        kcf=KCFConfig(scale_step=1.05))
    div = [c for c, rc in feats if not rc]
    resp = [c for c, rc in feats if rc]
    assert div and all(len(c) == 4 for c in div), feats
    assert resp and all(len(c) == 5 and c[0] == 2 for c in resp), feats
    # One trace (frame>0 path) may appear once or twice (frame-0 trace
    # has no detect pass) — the invariant is the per-trace 1:1 pairing.
    assert len(div) == len(resp), feats


def test_multiscale_refined_site_routing(monkeypatch):
    """3-scale + train_site=refined: ALL detect-pass spectra are
    response-class (none reach the divide); train's forward keeps the
    divide class on its re-extracted features."""
    feats = _trace_step(monkeypatch, train_site="refined",
                        kcf=KCFConfig(scale_step=1.05))
    unit_resp = [c for c, rc in feats if rc and len(c) == 4]
    off_resp = [c for c, rc in feats if rc and len(c) == 5]
    train_div = [c for c, rc in feats if not rc and len(c) == 4]
    assert unit_resp and off_resp and train_div, feats


def test_unit_scale_detect_site_single_forward(monkeypatch):
    """Unit scale + train_site=detect: exactly one feature forward per
    traced step, divide-class (detect renders from it AND train divides
    by it — the reuse the r5 change makes explicit)."""
    feats = _trace_step(monkeypatch, train_site="detect")
    assert feats and all(not rc for _, rc in feats), feats
    assert all(len(c) == 4 for c, _ in feats), feats
    # Reuse means one forward per trace: <= number of distinct traces (2:
    # frame-0 mass-birth trace + steady-state trace).
    assert len(feats) <= 2, feats
