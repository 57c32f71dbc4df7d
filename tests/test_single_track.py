"""Single-track KCF integration: OTB-config stand-in (SURVEY.md §4.2,
BASELINE.json configs[1]) — the batched tracker with T=1 must follow a
moving textured object and match the NumPy oracle trajectory."""

import numpy as np

from jaxmot.data import synthetic
from jaxmot.tracker.kcf_bank import KCFTracker
from jaxmot.config import KCFConfig

import oracles


def _sequence(n_frames=40, seed=3):
    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24,
                                      vx=2.0, vy=1.2)]
    return synthetic.render_sequence(objs, n_frames, 240, 320, seed=seed,
                                     noise=0.0)


def test_kcf_tracks_moving_object():
    frames, boxes, _ = _sequence()
    tracker = KCFTracker(KCFConfig())
    tracker.init(frames[0], boxes[0, 0])
    errs = []
    for f in range(1, len(frames)):
        box, peak = tracker.update(frames[f])
        gt = boxes[f, 0]
        errs.append(np.hypot(box[0] - gt[0], box[1] - gt[1]))
    # Center error within a fraction of the object size on every frame.
    assert max(errs) < 6.0, max(errs)
    assert np.mean(errs) < 3.0, np.mean(errs)


def test_kcf_matches_oracle_trajectory():
    frames, boxes, _ = _sequence(n_frames=25)
    cfg = KCFConfig()
    tracker = KCFTracker(cfg)
    tracker.init(frames[0], boxes[0, 0])
    oracle = oracles.KCFOracle(size=cfg.template_size, padding=cfg.padding,
                               sigma=cfg.kernel_sigma, lambda_=cfg.lambda_,
                               output_sigma_factor=cfg.output_sigma_factor,
                               interp_factor=cfg.interp_factor)
    oracle.init(frames[0], boxes[0, 0])
    for f in range(1, len(frames)):
        got, _ = tracker.update(frames[f])
        want, _ = oracle.update(frames[f])
        # float32 FFT-domain EMA vs float64 oracle: tolerance budget of
        # SURVEY.md §7(d) — sub-pixel agreement per frame.
        np.testing.assert_allclose(got[:2], want[:2], atol=0.75,
                                   err_msg=f"frame {f}")


def test_scan_otb_matches_per_frame_wrapper():
    """run_otb_sequence (one device program per clip) must produce the
    same trajectory as the per-frame KCFTracker.update loop."""
    import jax.numpy as jnp
    from jaxmot.tracker import kcf_bank
    from jaxmot.ops import patch as patch_ops

    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24,
                                      vx=2.0, vy=1.2)]
    frames, boxes, _ = synthetic.render_sequence(objs, 20, 240, 320,
                                                 seed=3, noise=0.0)
    cfg = KCFConfig()

    t = KCFTracker(cfg)
    t.init(frames[0], boxes[0, 0])
    want = []
    for f in range(1, 20):
        b, _ = t.update(frames[f])
        want.append(b)

    gray0 = patch_ops.to_gray(jnp.asarray(frames[0]))
    bank = kcf_bank.init_bank(gray0, jnp.asarray(boxes[0, :1]),
                              jnp.ones((1,), bool), cfg)
    _, got_boxes, _ = kcf_bank.run_otb_sequence(
        bank, jnp.asarray(frames[1:]), cfg)
    np.testing.assert_allclose(np.asarray(got_boxes[:, 0]),
                               np.asarray(want), rtol=1e-4, atol=1e-3)


def test_otb_detect_site_precision_parity():
    """Detect-site retraining (train_site="detect") on the single-object
    OTB flow: center error must stay within a fraction of a pixel of the
    refined-site default on a moving target (the same-frame spatial
    approximation must not cost tracking precision)."""
    import jax.numpy as jnp
    from jaxmot.ops import patch as patch_ops
    from jaxmot.tracker import kcf_bank

    objs = [synthetic.SyntheticObject(cx=100, cy=90, w=30, h=26,
                                      vx=3.0, vy=-2.0)]
    n = 30
    frames, boxes, _ = synthetic.render_sequence(objs, n, 240, 320,
                                                 seed=11, noise=0.01)
    cfg = KCFConfig()
    gray0 = patch_ops.to_gray(jnp.asarray(frames[0]))
    bank0 = kcf_bank.init_bank(gray0, jnp.asarray(boxes[0, :1]),
                               jnp.ones((1,), bool), cfg)

    errs = {}
    for site in ("refined", "detect"):
        _, got, _ = kcf_bank.run_otb_sequence(
            bank0, jnp.asarray(frames[1:]), cfg, train_site=site)
        got = np.asarray(got[:, 0])                     # [N-1, 4]
        gt = boxes[1:, 0]
        err = np.hypot(got[:, 0] - gt[:, 0], got[:, 1] - gt[:, 1])
        errs[site] = err
        assert err.max() < 2.5, (site, err.max())
    assert errs["detect"].mean() <= errs["refined"].mean() + 0.3, errs
