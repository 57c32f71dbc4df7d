"""Batched 2-D real FFT for the KCF core as matrix products.

The reference's L0 layer is a CPU FFT library call per track per frame
(SURVEY.md §2 row "fft2d").  Here the patch sizes are tiny (64x64,
BASELINE.json configs[1]) and the batch is the whole live-track bank, so
the formulation is not an FFT butterfly at all: a 64-point DFT is a 64x64
matrix, and a batched 2-D DFT is two batched matmuls for the matrix units.
Two interchangeable backends are provided:

  * "matmul" — DFT-by-matrix-multiply in pure real arithmetic (6 real
    matmuls per transform), the shipped path.  No complex dtype anywhere
    (see ops/cfloat.py).
  * "xla"    — jnp.fft.rfft2/irfft2 (complex internally, split at the
    boundary), used as a cross-check backend in the CPU test tier.

Both return/accept split-complex CF half-spectra of shape
[..., H, W//2 + 1] so the KCF math is backend-agnostic.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np

from jaxmot.ops.cfloat import CF

# Module-level default backend; tests exercise both explicitly.
_DEFAULT_BACKEND = "matmul"

# DFT matmul precision.  The sensitivity is ASYMMETRIC: the FORWARD
# feature spectra feed train()'s spectral divide, where operand rounding
# corrupts alphaf multiplicatively, while the INVERSE transforms only
# render response surfaces whose sub-pixel peak tolerates it.  A matrix
# unit that rounds f32 operands to bf16 (8 mantissa bits) at DEFAULT
# swaps identities on the identical-texture bounce canary
# (tools/bounce_fixture.py) unless the forward dots run at HIGH — hence
# "fwd_high" (forward=HIGH, inverse=DEFAULT), the "auto" resolution.
# On the H100 (XLA GPU, jax 0.9) an f32 dot at DEFAULT and at HIGH both
# run in TF32 (10 mantissa bits; ~3e-4 relative error on a DFT-shaped
# dot) and HIGHEST in full f32 (~2e-7); every mode keeps the canary's
# IDF1 at 0.987 and the tracker chunk's frames/s within run-to-run
# spread of each other, so the shipped resolution stays (PERF.md, PR 1).
_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "high": jax.lax.Precision.HIGH,
               "default": jax.lax.Precision.DEFAULT}
# mode -> (forward precision, inverse precision).
_MODES = {"highest": ("highest", "highest"),
          "high": ("high", "high"),
          "fwd_high": ("high", "default"),
          "default": ("default", "default")}
# Mode default outside any scope (standalone/oracle use stays
# accuracy-first); the tracker scopes each trace per cfg.kcf_precision.
# The scoped mode is THREAD-LOCAL: trace-time scoping is
# correct for the cfg-static jit call sites, but concurrent traces
# (e.g. the async API compiling two cfgs from worker threads) must not
# cross-contaminate each other's precision mode.
import threading as _threading

_PREC_TLS = _threading.local()


def set_default_precision(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown fft precision mode {mode!r}")
    _PREC_TLS.mode = mode


def get_default_precision() -> str:
    return getattr(_PREC_TLS, "mode", "highest")


@contextlib.contextmanager
def precision_scope(mode: str):
    """Trace-time scope pinning the DFT matmul precision mode (used by
    the *_auto dispatchers to honor cfg.kcf_precision on the XLA chain;
    safe because configs are jit statics — each cfg traces its own
    program).  Thread-local: concurrent traces do not interact."""
    if mode not in _MODES:
        raise ValueError(f"unknown fft precision mode {mode!r}")
    prev = get_default_precision()
    _PREC_TLS.mode = mode
    try:
        yield
    finally:
        _PREC_TLS.mode = prev


def _einsum_fwd(*args):
    prec = _MODES[get_default_precision()][0]
    return jnp.einsum(*args, precision=_PRECISIONS[prec])


def _einsum_inv(*args):
    prec = _MODES[get_default_precision()][1]
    return jnp.einsum(*args, precision=_PRECISIONS[prec])


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int, half: bool):
    """Forward DFT matrix F[j, k] = exp(-2i*pi*j*k/n), split into (re, im).

    With half=True only the first n//2+1 rows are kept (rfft columns).
    """
    j = np.arange(n // 2 + 1 if half else n)[:, None]
    k = np.arange(n)[None, :]
    w = np.exp(-2j * np.pi * j * k / n)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _idft_mats(n: int, half: bool):
    """Inverse-DFT basis E[m, j] = exp(+2i*pi*j*m/n), split into (re, im).

    With half=True only the first n//2+1 columns are kept.
    """
    m = np.arange(n)[:, None]
    j = np.arange(n // 2 + 1 if half else n)[None, :]
    w = np.exp(2j * np.pi * m * j / n)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _hermitian_weights(w: int):
    """Column weights folding the conjugate-symmetric half back in: 2 for
    interior columns, 1 for DC and (even w) Nyquist."""
    wf = w // 2 + 1
    wts = np.full((wf,), 2.0, np.float32)
    wts[0] = 1.0
    if w % 2 == 0:
        wts[-1] = 1.0
    return wts


def rfft2_matmul(x: jnp.ndarray, einsum=None) -> CF:
    """2-D real FFT over the last two axes via matrix products.

    Y = F_H @ X @ F_W^T with F_W truncated to the half spectrum:
    6 real matmuls, batched over every leading axis.

    einsum selects the precision class (default the forward/divide
    class; rfft2(response_class=True) passes the inverse/response-
    rendering class — see rfft2's docstring).
    """
    e = einsum or _einsum_fwd
    h, w = x.shape[-2], x.shape[-1]
    wf = w // 2 + 1
    ar, ai = _dft_mats(h, half=False)       # [H, H]
    br, bi = _dft_mats(w, half=True)        # [Wf, W]
    # P + iQ = X @ B^T  (X real)
    p = e("...hw,fw->...hf", x, br)
    q = e("...hw,fw->...hf", x, bi)
    # (Ar + iAi) @ (P + iQ)
    yr = e("gh,...hf->...gf", ar, p) - e("gh,...hf->...gf", ai, q)
    yi = e("gh,...hf->...gf", ar, q) + e("gh,...hf->...gf", ai, p)
    return CF(yr, yi)


def irfft2_matmul(yf: CF, w: int) -> jnp.ndarray:
    """Inverse of rfft2_matmul: real output [..., H, w] from the half
    spectrum [..., H, w//2+1], using Hermitian column folding.

    x = Re(E_H @ (wts * Y) @ E_W^T) / (H*w); 6 real matmuls.
    """
    h = yf.re.shape[-2]
    wts = _hermitian_weights(w)
    wf = yf.re.shape[-1]
    er, ei = _idft_mats(h, half=False)      # [H, H]
    gr, gi = _idft_mats(w, half=True)       # [w, Wf]
    yr = yf.re * wts
    yi = yf.im * wts
    # M + iN = E_H @ Yw
    m = _einsum_inv("mh,...hf->...mf", er, yr) - _einsum_inv(
        "mh,...hf->...mf", ei, yi)
    n = _einsum_inv("mh,...hf->...mf", er, yi) + _einsum_inv(
        "mh,...hf->...mf", ei, yr)
    # Re((M + iN) @ (Gr + iGi)^T) = M Gr^T - N Gi^T
    x = _einsum_inv("...mf,nf->...mn", m, gr) - _einsum_inv(
        "...mf,nf->...mn", n, gi)
    return x / (h * w)


def rfft2(x: jnp.ndarray, backend: str | None = None,
          response_class: bool = False) -> CF:
    """Batched 2-D rFFT over the last two axes → CF half spectrum.

    response_class=True assigns this transform to the RESPONSE-RENDERING
    precision class (the mode's inverse slot) instead of the
    divide-feeding forward class.  Rationale (the asymmetry in the
    _PRECISIONS comment): rounding in spectra that reach train()'s
    spectral divide corrupts alphaf multiplicatively, while spectra that
    only render a response surface tolerate it (the sub-pixel peak is
    insensitive at ~2e-3 relative noise).  detect()'s forward DFT of the
    correlation surface k is response-only, so under "fwd_high" it rides
    DEFAULT with the inverse transforms.  On CPU (f32 exact) and in
    uniform modes (fwd==inv) this is a no-op.
    """
    backend = backend or _DEFAULT_BACKEND
    if backend == "xla":
        yf = jnp.fft.rfft2(x)
        return CF(jnp.real(yf).astype(jnp.float32),
                  jnp.imag(yf).astype(jnp.float32))
    return rfft2_matmul(x, _einsum_inv if response_class else None)


def irfft2(yf: CF, w: int, backend: str | None = None) -> jnp.ndarray:
    """Batched inverse 2-D rFFT → real [..., H, w]."""
    backend = backend or _DEFAULT_BACKEND
    if backend == "xla":
        import jax
        z = jax.lax.complex(yf.re, yf.im)
        return jnp.fft.irfft2(z, s=(yf.re.shape[-2], w)).astype(jnp.float32)
    return irfft2_matmul(yf, w)
