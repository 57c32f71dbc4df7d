"""Batched KCF correlation-filter math (train / detect) in the FFT domain.

Batched re-design of the reference's per-track C KCF core (SURVEY.md §1
layers L0-L1; §3.2 hot loops 1-2): instead of looping tracks and calling a
CPU FFT per track, every op here carries a leading track-bank axis and lowers
to batched matmuls and fused elementwise programs.  Spectra are split-
complex CF pairs (ops/cfloat.py) — no complex dtype anywhere.  Math follows
arXiv:1404.7584 (KCF):

  * Gaussian kernel correlation   — eq. 31
  * Dual-space ridge train        — eq. 17:  alpha_f = y_f / (k_f + lambda)
  * Detection response            — eq. 22:  r = ifft(k_f * alpha_f)

Feature banks are [T, C, S, S] real; spectra [T, C, S, Sf] with
Sf = S//2 + 1 (rfft2 half spectrum).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxmot.ops import cfloat
from jaxmot.ops import fft as fft_ops
from jaxmot.ops import window as window_ops
from jaxmot.ops.cfloat import CF


class KCFModel(NamedTuple):
    """Per-track learned state: template spectrum and dual coefficients.

    The reference keeps (template features, alpha) per tracker object; here
    the whole bank lives in dense arrays so train/detect are one program
    over all tracks.
    """
    xf: CF        # [T, C, S, Sf] — model template spectrum
    alphaf: CF    # [T, S, Sf]   — dual coefficients


def _parseval_energy(xf: CF, width: int) -> jnp.ndarray:
    """sum(|x|^2) over (C, S, S) computed from the half spectrum.

    Parseval with Hermitian column folding: ||x||^2 = sum(w_k |X|^2) / N.
    Returns [...] (leading batch dims of xf minus the last three)."""
    wts = fft_ops._hermitian_weights(width)
    n = xf.re.shape[-2] * width
    power = cfloat.abs2(xf) * wts
    return jnp.sum(power, axis=(-3, -2, -1)) / n


def gaussian_correlation(xf: CF, zf: CF, sigma: float, width: int,
                         backend: str | None = None,
                         response_only: bool = False) -> CF:
    """Gaussian-kernel correlation k^{xz} for all cyclic shifts, in one shot.

    arXiv:1404.7584 eq. 31:
      k[tau] = exp(-(||x||^2 + ||z||^2 - 2 x^T z_tau) / (sigma^2 * N))
    with the cross term for every shift tau obtained by one inverse FFT of
    sum_c X_c * conj(Z_c).

    xf, zf : [..., C, S, Sf] spectra.  Returns k_f = rfft2(k) [..., S, Sf].

    response_only=True marks the returned spectrum as feeding ONLY a
    response surface (detect's k^{xz} → irfft(kf·alphaf)), so its
    forward DFT runs in the response-rendering precision class; train's
    k^{xx} feeds the spectral divide and keeps the divide-class forward
    (see ops/fft.rfft2 response_class for the measured asymmetry).
    """
    s = xf.re.shape[-2]
    c = xf.re.shape[-3]
    xx = _parseval_energy(xf, width)                     # [...]
    zz = _parseval_energy(zf, width)
    cross_f = cfloat.sum_axis(cfloat.mul_conj(xf, zf), axis=-3)
    cross = fft_ops.irfft2(cross_f, width, backend)      # [..., S, S]
    numel = s * width * c
    d = (xx + zz)[..., None, None] - 2.0 * cross
    k = jnp.exp(-jnp.maximum(d, 0.0) / (sigma * sigma * numel))
    return fft_ops.rfft2(k, backend, response_class=response_only)


def train(feat: jnp.ndarray, yf: CF, sigma: float, lambda_: float,
          backend: str | None = None) -> KCFModel:
    """One-shot ridge training on a feature bank (eq. 17).

    feat : [T, C, S, S] windowed features.
    yf   : [S, Sf] spectrum of the desired Gaussian response (shared).
    Returns the newly-trained KCFModel bank (no EMA blending).
    """
    s = feat.shape[-1]
    xf = fft_ops.rfft2(feat, backend)
    return train_from_spectrum(xf, yf, sigma, lambda_, s, backend)


def train_from_spectrum(xf: CF, yf: CF, sigma: float, lambda_: float,
                        width: int, backend: str | None = None
                        ) -> KCFModel:
    """train() when the feature spectrum is already in hand — the
    detect-site training path (tracker.step train_site="detect") feeds
    the phase-aligned detection spectra here instead of re-extracting
    patches at the corrected boxes.

    Note: the self-correlation k^xx depends only on |X| (phases cancel in
    X·conj(X)), so alphaf is invariant under shift_spectrum alignment —
    only the template xf carries the phase (asserted in
    tests/test_train_site.py)."""
    kf = gaussian_correlation(xf, xf, sigma, width, backend)
    alphaf = cfloat.div_real_shifted(yf, kf, lambda_)
    return KCFModel(xf=xf, alphaf=alphaf)


def shift_spectrum(zf: CF, dy: jnp.ndarray, dx: jnp.ndarray,
                   width: int) -> CF:
    """Circularly translate patches by (+dy, +dx) pixels in the Fourier
    domain: the spectrum of f(n + d) is f̂(k)·e^{+2πi k·d/N} — sub-pixel
    shifts are exact in the band-limited (sinc-interpolation) sense.

    zf : [T, C, S, Sf] half spectra, dy/dx : [T] float row/col shifts.
    Row frequencies must be SIGNED for fractional shifts (e^{2πi k d/N}
    ≠ e^{2πi (k−N) d/N} unless d is integral); the rfft column axis is
    already non-negative so its indices are used directly.
    """
    s = zf.re.shape[-2]
    sf = zf.re.shape[-1]
    ky = (jnp.arange(s) + s // 2) % s - s // 2            # signed rows
    kx = jnp.arange(sf)                                   # rfft cols
    theta = (2.0 * jnp.pi) * (
        ky[None, :, None] * (dy[:, None, None] / s)
        + kx[None, None, :] * (dx[:, None, None] / width))  # [T, S, Sf]
    c = jnp.cos(theta)[:, None]                           # broadcast C
    sn = jnp.sin(theta)[:, None]
    return CF(zf.re * c - zf.im * sn, zf.re * sn + zf.im * c)


def blend(model: KCFModel, new: KCFModel, lr) -> KCFModel:
    """EMA model update ("interp factor" in the C lineage).

    lr may be a scalar or a per-track [T] array (e.g. 1.0 for fresh slots,
    interp_factor for matched tracks, 0.0 for unmatched — the bank-wide
    masked update replacing the reference's per-track branching)."""
    lr = jnp.asarray(lr, jnp.float32)
    lr_x = lr.reshape(lr.shape + (1,) * (model.xf.re.ndim - lr.ndim))
    lr_a = lr.reshape(lr.shape + (1,) * (model.alphaf.re.ndim - lr.ndim))
    return KCFModel(
        xf=cfloat.lerp(model.xf, new.xf, lr_x),
        alphaf=cfloat.lerp(model.alphaf, new.alphaf, lr_a),
    )


def detect_from_spectrum(model: KCFModel, zf: CF, sigma: float,
                         width: int, backend: str | None = None
                         ) -> jnp.ndarray:
    """detect() when the feature spectrum is already in hand.

    The fused step computes zf itself so the forward-DFT precision class
    can be routed per scale: under train_site="detect" only the
    UNIT-scale spectrum reaches train()'s spectral divide (step 8 trains
    from feats_unit), so the off-scale spectra — response-rendering only
    — ride the inverse class instead of fwd_high's HIGH forward
    precision (see ops/fft.rfft2 and tracker/step.py).

    zf broadcasts over leading axes against the [T, ...] model (the
    multi-scale [K, T, C, S, Sf] layout).  Returns [..., S, S] real.
    """
    kf = gaussian_correlation(zf, model.xf, sigma, width, backend,
                              response_only=True)
    return fft_ops.irfft2(kf * model.alphaf, width, backend)


def detect(model: KCFModel, feat: jnp.ndarray, sigma: float,
           backend: str | None = None) -> jnp.ndarray:
    """Correlation response of the model bank on new patches (eq. 22).

    feat : [T, C, S, S] features at the predicted ROIs.
    Returns response [T, S, S] real.
    """
    s = feat.shape[-1]
    zf = fft_ops.rfft2(feat, backend)
    return detect_from_spectrum(model, zf, sigma, s, backend)


def peak_displacement(response: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Locate the response peak with sub-pixel refinement.

    The training target's peak sits at the patch center (window.gaussian_peak),
    so displacement = argmax - center, refined by a 1-D parabola fit on each
    axis (the reference lineage's subPixelPeak).

    response : [T, S, S] → (dy [T], dx [T], peak [T]) in template pixels.
    """
    t, s, _ = response.shape
    flat = response.reshape(t, s * s)
    idx = jnp.argmax(flat, axis=1)
    peak = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    py = idx // s
    px = idx % s

    def axis_neighbors(p, along_y):
        lo = jnp.maximum(p - 1, 0)
        hi = jnp.minimum(p + 1, s - 1)
        if along_y:
            left = flat[jnp.arange(t), lo * s + px]
            right = flat[jnp.arange(t), hi * s + px]
        else:
            left = flat[jnp.arange(t), py * s + lo]
            right = flat[jnp.arange(t), py * s + hi]
        return left, right

    def subpixel(p, left, right):
        denom = 2.0 * peak - left - right
        delta = jnp.where(jnp.abs(denom) > 1e-8,
                          0.5 * (right - left) / jnp.maximum(denom, 1e-8),
                          0.0)
        # Only refine interior peaks; clamp the fit to half a pixel.
        delta = jnp.clip(delta, -0.5, 0.5)
        interior = (p > 0) & (p < s - 1)
        return jnp.where(interior, delta, 0.0)

    ly, ry = axis_neighbors(py, True)
    lx, rx = axis_neighbors(px, False)
    dy = py.astype(jnp.float32) + subpixel(py, ly, ry) - (s // 2)
    dx = px.astype(jnp.float32) + subpixel(px, lx, rx) - (s // 2)
    return dy, dx, peak


def psr(response: jnp.ndarray, peak: jnp.ndarray,
        exclude: int = 5) -> jnp.ndarray:
    """Peak-to-sidelobe ratio — the correlation-filter confidence measure
    of the reference lineage (MOSSE/KCF practice): (peak - mean_sidelobe)
    / std_sidelobe, with an exclusion window around the peak.

    response : [T, S, S]; peak : [T] (max response values).
    Returns [T] PSR; higher = sharper, more trustworthy peak.
    """
    t, sz, _ = response.shape
    flat = response.reshape(t, sz * sz)
    idx = jnp.argmax(flat, axis=1)
    py = (idx // sz).astype(jnp.float32)
    px = (idx % sz).astype(jnp.float32)
    yy = jax.lax.broadcasted_iota(jnp.float32, (sz, sz), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (sz, sz), 1)
    side = ((jnp.abs(yy[None] - py[:, None, None]) > exclude)
            | (jnp.abs(xx[None] - px[:, None, None]) > exclude))
    n = jnp.maximum(jnp.sum(side, axis=(1, 2)), 1.0)
    mean = jnp.sum(jnp.where(side, response, 0.0), axis=(1, 2)) / n
    var = jnp.sum(jnp.where(side, (response - mean[:, None, None]) ** 2,
                            0.0), axis=(1, 2)) / n
    return (peak - mean) / jnp.sqrt(var + 1e-8)


def make_yf(size: int, padding: float, output_sigma_factor: float,
            backend: str | None = None) -> CF:
    """Spectrum of the shared desired-response Gaussian [S, Sf]."""
    sigma = window_ops.output_sigma(size, size, padding, output_sigma_factor)
    y = window_ops.gaussian_peak(size, size, sigma)
    return fft_ops.rfft2(jnp.asarray(y), backend)
