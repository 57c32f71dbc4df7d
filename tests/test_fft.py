"""Parity tests for the batched rFFT backends (SURVEY.md §4.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from jaxmot.ops import fft as fft_ops
from jaxmot.ops.cfloat import CF, mul_conj


def _to_np(cf):
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def test_rfft2_matmul_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 64, 64)).astype(np.float32)
    got = _to_np(fft_ops.rfft2(jnp.asarray(x), backend="matmul"))
    want = np.fft.rfft2(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_rfft2_xla_matches_numpy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    got = _to_np(fft_ops.rfft2(jnp.asarray(x), backend="xla"))
    want = np.fft.rfft2(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_irfft2_roundtrip_matmul():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64, 64)).astype(np.float32)
    xf = fft_ops.rfft2(jnp.asarray(x), backend="matmul")
    back = np.asarray(fft_ops.irfft2(xf, 64, backend="matmul"))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_irfft2_roundtrip_xla():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32)).astype(np.float32)
    xf = fft_ops.rfft2(jnp.asarray(x), backend="xla")
    back = np.asarray(fft_ops.irfft2(xf, 32, backend="xla"))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_irfft2_matmul_odd_width():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 15)).astype(np.float32)
    xf_np = np.fft.rfft2(x)
    xf = CF(jnp.asarray(xf_np.real.astype(np.float32)),
            jnp.asarray(xf_np.imag.astype(np.float32)))
    back = np.asarray(fft_ops.irfft2(xf, 15, backend="matmul"))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_backends_agree_on_cross_spectrum():
    """The exact spectral product used by gaussian_correlation."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 64, 64)).astype(np.float32)
    b = rng.standard_normal((2, 64, 64)).astype(np.float32)
    for backend in ("matmul", "xla"):
        af = fft_ops.rfft2(jnp.asarray(a), backend=backend)
        bf = fft_ops.rfft2(jnp.asarray(b), backend=backend)
        got = np.asarray(fft_ops.irfft2(mul_conj(af, bf), 64,
                                        backend=backend))
        want = np.real(np.fft.ifft2(np.fft.fft2(a) * np.conj(np.fft.fft2(b))))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def test_response_class_rfft2_selects_inverse_precision(monkeypatch):
    """rfft2(response_class=True) must route ALL 6 of its matmuls through
    the INVERSE
    (response-rendering) precision class and be numerically identical on
    CPU (the CPU computes every precision in f32).  Rationale in
    ops/fft.rfft2's docstring (r4 asymmetry finding)."""
    n_dots = 6
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((3, 64, 64)).astype(np.float32))
    base = fft_ops.rfft2(x, backend="matmul")

    calls = {"fwd": 0, "inv": 0}
    orig_fwd, orig_inv = fft_ops._einsum_fwd, fft_ops._einsum_inv

    def fwd(*a):
        calls["fwd"] += 1
        return orig_fwd(*a)

    def inv(*a):
        calls["inv"] += 1
        return orig_inv(*a)

    monkeypatch.setattr(fft_ops, "_einsum_fwd", fwd)
    monkeypatch.setattr(fft_ops, "_einsum_inv", inv)
    got = fft_ops.rfft2(x, backend="matmul", response_class=True)
    assert calls == {"fwd": 0, "inv": n_dots}, calls
    np.testing.assert_array_equal(np.asarray(got.re), np.asarray(base.re))
    np.testing.assert_array_equal(np.asarray(got.im), np.asarray(base.im))

    calls["inv"] = 0
    fft_ops.rfft2(x, backend="matmul", response_class=False)
    assert calls == {"fwd": n_dots, "inv": 0}, calls


def test_detect_response_only_wiring(monkeypatch):
    """detect()'s gaussian_correlation output spectrum is response-only:
    its forward DFT rides the inverse class, while train()'s k^xx keeps
    the divide-class forward (the shipped fwd_high split depends on it)."""
    from jaxmot.ops import kcf as kcf_ops

    rng = np.random.default_rng(12)
    t, c, s = 2, 1, 32
    feat = jnp.asarray(rng.standard_normal((t, c, s, s)).astype(np.float32))
    yf = kcf_ops.make_yf(s, 2.5, 0.125, backend="matmul")
    model = kcf_ops.train(feat, yf, 0.2, 1e-4, backend="matmul")

    calls = {"inv_fwd6": 0}
    orig = fft_ops.rfft2_matmul

    def spy(x, einsum=None):
        if einsum is fft_ops._einsum_inv:
            calls["inv_fwd6"] += 1
        return orig(x, einsum)

    monkeypatch.setattr(fft_ops, "rfft2_matmul", spy)
    kcf_ops.detect(model, feat, 0.2, backend="matmul")
    assert calls["inv_fwd6"] == 1, calls   # exactly the rfft2(k) in detect
    calls["inv_fwd6"] = 0
    kcf_ops.train(feat, yf, 0.2, 1e-4, backend="matmul")
    assert calls["inv_fwd6"] == 0, calls   # train's k^xx stays divide-class


@pytest.mark.parametrize("h,w", [(64, 64), (32, 48), (16, 17), (16, 15)])
def test_matmul_chain_shapes_vs_numpy(h, w):
    """The matmul rFFT and its inverse against NumPy's float64 FFT on
    even, mixed and both odd-width parities (16x17 and 16x15 exercise the
    Nyquist-less Hermitian fold from each side)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, h, w)).astype(np.float32)
    xf = fft_ops.rfft2(jnp.asarray(x), backend="matmul")
    np.testing.assert_allclose(_to_np(xf), np.fft.rfft2(x.astype(np.float64)),
                               rtol=1e-4, atol=1e-3)
    back = np.asarray(fft_ops.irfft2(xf, w, backend="matmul"))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_precision_modes_route_each_direction(monkeypatch):
    """Each kcf_precision mode names a (forward, inverse) dot precision;
    the scope sets it for the trace and restores the outer mode after."""
    seen = []
    orig = fft_ops.jnp.einsum

    def spy(*a, precision=None):
        seen.append(precision)
        return orig(*a, precision=precision)

    x = jnp.ones((1, 8, 8), jnp.float32)
    P = fft_ops.jax.lax.Precision
    want = {"highest": (P.HIGHEST, P.HIGHEST), "high": (P.HIGH, P.HIGH),
            "fwd_high": (P.HIGH, P.DEFAULT),
            "default": (P.DEFAULT, P.DEFAULT)}
    outer = fft_ops.get_default_precision()
    monkeypatch.setattr(fft_ops.jnp, "einsum", spy)
    for mode, (fwd, inv) in want.items():
        seen.clear()
        with fft_ops.precision_scope(mode):
            fft_ops.irfft2(fft_ops.rfft2(x, backend="matmul"), 8,
                           backend="matmul")
        assert seen == [fwd] * 6 + [inv] * 6, (mode, seen)
        assert fft_ops.get_default_precision() == outer
    with pytest.raises(ValueError):
        with fft_ops.precision_scope("bf16"):
            pass
