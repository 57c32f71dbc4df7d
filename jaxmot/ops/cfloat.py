"""Split-complex arithmetic: spectra as explicit (re, im) float32 pairs.

Design decision: the DFTs run as real matrix products (ops/fft.py), so
the framework's FFT domain is a `CF` pytree of two real arrays, with the
handful of complex ops the KCF math needs spelled out — each lowers to
plain elementwise code that XLA fuses with its neighbours, and no complex
dtype reaches a matrix product or a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CF(NamedTuple):
    """A complex tensor as two same-shape real tensors."""
    re: jnp.ndarray
    im: jnp.ndarray

    @property
    def shape(self):
        return self.re.shape

    def __add__(self, other):
        if isinstance(other, CF):
            return CF(self.re + other.re, self.im + other.im)
        return CF(self.re + other, self.im)           # real scalar/array

    def __mul__(self, other):
        if isinstance(other, CF):
            return CF(self.re * other.re - self.im * other.im,
                      self.re * other.im + self.im * other.re)
        return CF(self.re * other, self.im * other)   # real scalar/array

    __rmul__ = __mul__


def conj(x: CF) -> CF:
    return CF(x.re, -x.im)


def mul_conj(x: CF, z: CF) -> CF:
    """x * conj(z)."""
    return CF(x.re * z.re + x.im * z.im,
              x.im * z.re - x.re * z.im)


def abs2(x: CF) -> jnp.ndarray:
    return x.re * x.re + x.im * x.im


def div_real_shifted(y: CF, k: CF, lam: float) -> CF:
    """y / (k + lam) — the dual-space ridge solve (arXiv:1404.7584 eq. 17)."""
    dr = k.re + lam
    denom = dr * dr + k.im * k.im
    inv = 1.0 / jnp.maximum(denom, 1e-20)
    return CF((y.re * dr + y.im * k.im) * inv,
              (y.im * dr - y.re * k.im) * inv)


def lerp(a: CF, b: CF, t) -> CF:
    """(1 - t) * a + t * b with real broadcastable t."""
    return CF(a.re * (1.0 - t) + b.re * t,
              a.im * (1.0 - t) + b.im * t)


def zeros(shape, dtype=jnp.float32) -> CF:
    return CF(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def sum_axis(x: CF, axis) -> CF:
    return CF(jnp.sum(x.re, axis=axis), jnp.sum(x.im, axis=axis))
