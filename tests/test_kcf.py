"""KCF core parity vs the NumPy oracle + behavioral shift tests
(SURVEY.md §4.1-4.2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from jaxmot.ops import fft as fft_ops
from jaxmot.ops import kcf as kcf_ops
from jaxmot.ops import patch as patch_ops
from jaxmot.ops import features as feat_ops

import oracles


def _rand_feat(rng, t=3, c=2, s=64):
    return rng.standard_normal((t, c, s, s)).astype(np.float32) * 0.1


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_gaussian_correlation_vs_oracle(backend):
    rng = np.random.default_rng(0)
    x = _rand_feat(rng)
    z = _rand_feat(rng)
    xf = fft_ops.rfft2(jnp.asarray(x), backend=backend)
    zf = fft_ops.rfft2(jnp.asarray(z), backend=backend)
    kf = kcf_ops.gaussian_correlation(xf, zf, 0.2, 64, backend=backend)
    got = np.asarray(fft_ops.irfft2(kf, 64, backend=backend))
    for t in range(x.shape[0]):
        want = oracles.gaussian_correlation(x[t], z[t], 0.2)
        np.testing.assert_allclose(got[t], want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_train_matches_oracle_alphaf(backend):
    rng = np.random.default_rng(1)
    x = _rand_feat(rng, t=2, c=1)
    yf_half = kcf_ops.make_yf(64, 2.5, 0.125, backend=backend)
    model = kcf_ops.train(jnp.asarray(x), yf_half, 0.2, 1e-4,
                          backend=backend)
    oracle = oracles.KCFOracle()
    for t in range(2):
        k = oracles.gaussian_correlation(x[t], x[t], 0.2)
        want_full = oracle.yf / (np.fft.fft2(k) + 1e-4)
        got = (np.asarray(model.alphaf.re[t])
               + 1j * np.asarray(model.alphaf.im[t]))
        np.testing.assert_allclose(got, want_full[:, :33], rtol=1e-2,
                                   atol=1e-3)


def test_detect_recovers_exact_feature_shift():
    """Circulant ground truth: rolling the features by (dy, dx) must move
    the response peak to exactly (dy, dx) relative to center."""
    rng = np.random.default_rng(2)
    s = 64
    x = rng.standard_normal((s, s)).astype(np.float32) * 0.2
    fx = ((jnp.asarray(x)[None] - 0.5)
          * jnp.asarray(oracles.hann2d(s, s)))[:, None]
    yf = kcf_ops.make_yf(s, 2.5, 0.125)
    model = kcf_ops.train(fx, yf, 0.2, 1e-4)
    for dy, dx in [(0, 0), (3, -2), (-5, 4), (7, 7)]:
        fz = jnp.roll(fx, (dy, dx), (2, 3))
        resp = kcf_ops.detect(model, fz, 0.2)
        gy, gx, peak = kcf_ops.peak_displacement(np.asarray(resp))
        assert abs(float(gy[0]) - dy) <= 0.51, (dy, dx, float(gy[0]))
        assert abs(float(gx[0]) - dx) <= 0.51, (dy, dx, float(gx[0]))
        assert float(peak[0]) > 0.9


def test_detect_recovers_crop_shift_direction():
    """Moving the search window by +d shifts patch content by -d; the
    measured displacement must track it (the Hann window biases the
    magnitude slightly toward zero — tolerance 1 px, matching the
    oracle's behavior)."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((80, 80)).astype(np.float32) * 0.2
    s = 64
    x = base[8:8 + s, 8:8 + s]
    hann = jnp.asarray(oracles.hann2d(s, s))
    yf = kcf_ops.make_yf(s, 2.5, 0.125)
    fx = ((jnp.asarray(x)[None] - 0.5) * hann)[:, None]
    model = kcf_ops.train(fx, yf, 0.2, 1e-4)
    for dy, dx in [(3, -2), (-5, 4)]:
        z = base[8 + dy:8 + dy + s, 8 + dx:8 + dx + s]
        fz = ((jnp.asarray(z)[None] - 0.5) * hann)[:, None]
        resp = kcf_ops.detect(model, fz, 0.2)
        gy, gx, peak = kcf_ops.peak_displacement(np.asarray(resp))
        assert abs(float(gy[0]) + dy) <= 1.0, (dy, dx, float(gy[0]))
        assert abs(float(gx[0]) + dx) <= 1.0, (dy, dx, float(gx[0]))
        assert float(peak[0]) > 0.2


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_full_response_vs_oracle(backend):
    """End-to-end train+detect response parity on real patch pipeline."""
    rng = np.random.default_rng(3)
    frame = rng.random((120, 160)).astype(np.float32)
    box = np.array([80.0, 60.0, 24.0, 30.0])
    oracle = oracles.KCFOracle()
    oracle.init(frame, box)

    patches = patch_ops.extract_patches(jnp.asarray(frame),
                                        jnp.asarray(box)[None], 2.5, 64)
    feats = feat_ops.raw_gray_features(patches)
    yf = kcf_ops.make_yf(64, 2.5, 0.125, backend=backend)
    model = kcf_ops.train(feats, yf, 0.2, 1e-4, backend=backend)

    # Shift the frame content and compare responses.
    frame2 = np.roll(frame, (2, -3), axis=(0, 1)).astype(np.float32)
    patches2 = patch_ops.extract_patches(jnp.asarray(frame2),
                                         jnp.asarray(box)[None], 2.5, 64)
    feats2 = feat_ops.raw_gray_features(patches2)
    got = np.asarray(kcf_ops.detect(model, feats2, 0.2, backend=backend))[0]
    want = oracle.response(frame2)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)


def test_blend_per_track_lr():
    rng = np.random.default_rng(4)
    x = _rand_feat(rng, t=3, c=1)
    z = _rand_feat(rng, t=3, c=1)
    yf = kcf_ops.make_yf(64, 2.5, 0.125)
    m0 = kcf_ops.train(jnp.asarray(x), yf, 0.2, 1e-4)
    m1 = kcf_ops.train(jnp.asarray(z), yf, 0.2, 1e-4)
    lr = jnp.asarray([0.0, 0.5, 1.0])
    out = kcf_ops.blend(m0, m1, lr)
    np.testing.assert_allclose(np.asarray(out.xf.re[0]),
                               np.asarray(m0.xf.re[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.xf.im[2]),
                               np.asarray(m1.xf.im[2]), atol=1e-6)
    mid = 0.5 * (np.asarray(m0.alphaf.re[1]) + np.asarray(m1.alphaf.re[1]))
    np.testing.assert_allclose(np.asarray(out.alphaf.re[1]), mid, atol=1e-5)


def test_patch_extraction_matches_oracle():
    rng = np.random.default_rng(5)
    frame = rng.random((100, 140)).astype(np.float32)
    boxes = np.array([[70.0, 50.0, 20.0, 26.0],
                      [10.0, 90.0, 40.0, 12.0]])   # partially out of frame
    got = np.asarray(patch_ops.extract_patches(
        jnp.asarray(frame), jnp.asarray(boxes), 2.5, 64))
    oracle = oracles.KCFOracle()
    for i, b in enumerate(boxes):
        want = oracle.get_patch(frame, b)
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_psr_confidence():
    """PSR is high for a trained in-place match, low on an unrelated
    patch — sharper discrimination than the raw peak."""
    rng = np.random.default_rng(6)
    s = 64
    x = rng.standard_normal((1, s, s)).astype(np.float32) * 0.2
    hann = jnp.asarray(oracles.hann2d(s, s))
    fx = ((jnp.asarray(x) - 0.5) * hann)[:, None]
    yf = kcf_ops.make_yf(s, 2.5, 0.125)
    model = kcf_ops.train(fx, yf, 0.2, 1e-4)

    resp_same = kcf_ops.detect(model, fx, 0.2)
    other = rng.standard_normal((1, s, s)).astype(np.float32) * 0.2
    fo = ((jnp.asarray(other) - 0.5) * hann)[:, None]
    resp_other = kcf_ops.detect(model, fo, 0.2)

    _, _, pk_same = kcf_ops.peak_displacement(resp_same)
    _, _, pk_other = kcf_ops.peak_displacement(resp_other)
    psr_same = float(kcf_ops.psr(resp_same, pk_same)[0])
    psr_other = float(kcf_ops.psr(resp_other, pk_other)[0])
    assert psr_same > 20.0, psr_same
    assert psr_other < psr_same / 3, (psr_same, psr_other)
