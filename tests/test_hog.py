"""fHOG feature tests: structure, shift covariance, and KCF-HOG tracking."""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import KCFConfig
from jaxmot.data import synthetic
from jaxmot.ops import hog
from jaxmot.tracker.kcf_bank import KCFTracker


def test_shapes_and_finiteness():
    rng = np.random.default_rng(0)
    patches = rng.random((3, 64, 64)).astype(np.float32)
    feat = np.asarray(hog.hog_features(jnp.asarray(patches), cell=4))
    assert feat.shape == (3, 31, 16, 16)
    assert np.isfinite(feat).all()
    # Orientation channels are truncated; texture channels are sums.
    assert feat[:, :27].max() <= hog.TRUNC + 1e-5
    assert feat.min() >= 0.0


def test_uniform_patch_has_no_energy():
    patches = np.full((1, 64, 64), 0.5, np.float32)
    feat = np.asarray(hog.hog_features(jnp.asarray(patches), cell=4))
    assert np.abs(feat).max() < 1e-4


def test_cell_shift_covariance():
    """Shifting the patch by one cell shifts the feature map by one."""
    rng = np.random.default_rng(1)
    base = rng.random((1, 64, 64)).astype(np.float32)
    f0 = np.asarray(hog.hog_features(jnp.asarray(base), cell=4))
    shifted = np.roll(base, 4, axis=2)
    f1 = np.asarray(hog.hog_features(jnp.asarray(shifted), cell=4))
    # Interior columns must match the unshifted map moved by one cell
    # (edge cells leak slightly through block normalization — a true
    # misalignment would differ at the 0.1+ level everywhere).
    d = np.abs(f1[..., 2:-2, 3:-1] - f0[..., 2:-2, 2:-2])
    assert d.max() < 0.02 and d.mean() < 1e-3, (d.max(), d.mean())


def test_gradient_direction_selectivity():
    """A vertical edge activates different bins than a horizontal edge."""
    v = np.zeros((1, 64, 64), np.float32)
    v[:, :, 32:] = 1.0
    h = np.zeros((1, 64, 64), np.float32)
    h[:, 32:, :] = 1.0
    fv = np.asarray(hog.hog_features(jnp.asarray(v), cell=4))[0, :27]
    fh = np.asarray(hog.hog_features(jnp.asarray(h), cell=4))[0, :27]
    bv = np.argmax(fv.sum(axis=(1, 2)))
    bh = np.argmax(fh.sum(axis=(1, 2)))
    assert bv != bh


def test_kcf_hog_tracks_moving_object():
    """End-to-end: KCF in HOG mode follows the synthetic OTB fixture."""
    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24,
                                      vx=2.0, vy=1.2)]
    frames, boxes, _ = synthetic.render_sequence(objs, 30, 240, 320,
                                                 seed=3, noise=0.0)
    cfg = KCFConfig(feature_type="hog", cell_size=4, kernel_sigma=0.6,
                    interp_factor=0.02)
    tracker = KCFTracker(cfg)
    tracker.init(frames[0], boxes[0, 0])
    errs = []
    for f in range(1, 30):
        box, peak = tracker.update(frames[f])
        gt = boxes[f, 0]
        errs.append(np.hypot(box[0] - gt[0], box[1] - gt[1]))
    assert max(errs) < 8.0, max(errs)
    assert np.mean(errs) < 4.0, np.mean(errs)
