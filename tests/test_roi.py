"""ROI extraction (ops.patch) against the float64 bilinear oracle, plus
edge cases through the tracker step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jaxmot.ops import patch as patch_ops

import oracles
from chip_smoke import roi_boxes, smooth_frame

H, W, T = 96, 160, 9
SCALES = (1 / 1.05, 1.0, 1.05)


def _boxes(case, rng):
    """inside: windows inside the frame; border: windows overrunning the
    frame edge (clamped sampling); wide: windows wider than 128 px."""
    b = np.zeros((T, 4), np.float32)
    b[:, 0] = rng.uniform(40, W - 40, T)
    b[:, 1] = rng.uniform(30, H - 30, T)
    b[:, 2:] = rng.uniform(6, 12, (T, 2))
    if case == "border":
        b[:, 0] = rng.choice([-6.0, 3.0, W - 2.0, W + 8.0], T)
        b[:, 1] = rng.uniform(-10, H + 10, T)
        b[:, 2:] = rng.uniform(10, 30, (T, 2))
    elif case == "wide":
        b[:, 2:] = rng.uniform(56, 80, (T, 2))        # 2.5x -> 140-200 px
    return b


@pytest.mark.parametrize("case", ["inside", "border", "wide"])
@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "3scale"])
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_sampler_matches_float64_oracle(u8, scaled, case):
    """extract_patches(to_gray(frame)) within 1e-5 of the float64
    bilinear crop at every sample (smooth frame, so float32 coordinate
    rounding stays below the tolerance while a wrong gather index would
    not)."""
    rng = np.random.default_rng(
        [u8, scaled, ("inside", "border", "wide").index(case)])
    frame = smooth_frame(H, W, seed=3)
    if u8:
        frame = np.round(frame * 255).astype(np.uint8)
    boxes = _boxes(case, rng)
    if scaled:
        bx = np.tile(boxes, (len(SCALES), 1))
        sc = np.repeat(np.asarray(SCALES, np.float32), T)
    else:
        bx, sc = boxes, None
    got = np.asarray(patch_ops.extract_patches(
        patch_ops.to_gray(jnp.asarray(frame)), jnp.asarray(bx), 2.5, 64,
        scales=None if sc is None else jnp.asarray(sc)))
    gray = frame.astype(np.float64) / (255.0 if u8 else 1.0)
    want = oracles.roi_patches(gray, bx.astype(np.float64), 2.5, 64,
                               None if sc is None else sc.astype(np.float64))
    assert got.shape == (len(bx), 64, 64)
    assert np.max(np.abs(got - want)) <= 1e-5


def test_roi_box_fixture_covers_cases():
    """chip_smoke.roi_boxes (the on-card comparison's boxes) holds the
    three cases: inside, overrunning the border, windows > 128 px."""
    b = roi_boxes(30, 1080, 1920, seed=0)
    inside = (b[:, 0] > 0) & (b[:, 0] < 1920)
    assert inside.sum() < 30 and (~inside).sum() >= 10
    assert (b[:, 2:] * 2.5 > 128).any(axis=1).sum() >= 10


def test_degenerate_and_outside_boxes_finite():
    rng = np.random.default_rng(2)
    frame = rng.random((240, 320)).astype(np.float32)
    boxes = np.array([[10.0, 10.0, 0.0, 0.0],
                      [1000.0, 1000.0, 20.0, 20.0],
                      [-50.0, -50.0, 600.0, 600.0]], np.float32)
    got = np.asarray(patch_ops.extract_patches(
        jnp.asarray(frame), jnp.asarray(boxes), 2.5, 64))
    assert np.isfinite(got).all()
    # An all-outside window replicates the nearest frame corner.
    np.testing.assert_allclose(got[1], frame[-1, -1], rtol=0, atol=1e-6)


def test_u8_frame_through_tracker_step():
    """The fused step accepts uint8 frames (dequantized on device by
    to_gray) and tracks exactly like the f32-gray equivalent."""
    from jaxmot.config import TrackerConfig
    from jaxmot.tracker import api as api_mod

    rng = np.random.default_rng(8)
    frame_u8 = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    cfg = TrackerConfig(max_tracks=8, max_detections=4, frame_height=120,
                        frame_width=160)
    trk = api_mod.MultiTracker(cfg)
    dets = np.array([[40.0, 40.0, 20.0, 18.0, 0.9],
                     [100.0, 70.0, 24.0, 20.0, 0.8]], np.float32)
    trk.init(frame_u8, dets)
    trk2 = api_mod.MultiTracker(cfg)
    trk2.init(frame_u8.astype(np.float32) / 255.0, dets)
    np.testing.assert_allclose(
        np.asarray(trk.last_output.boxes),
        np.asarray(trk2.last_output.boxes), rtol=1e-4, atol=1e-4)
    # The u8 bank carries the same KCF spectra as the f32-gray bank.
    np.testing.assert_allclose(
        np.asarray(trk.bank.kcf.xf.re), np.asarray(trk2.bank.kcf.xf.re),
        rtol=1e-3, atol=1e-4)
