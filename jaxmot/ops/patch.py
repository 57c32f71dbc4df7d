"""Batched ROI patch extraction — on-device crop + bilinear resize.

Reference behavior: per-track subwindow crop with border replication, resized
to the fixed template (SURVEY.md §2 row "features"; §7 hard part (c)).  Here
all live tracks' variable-size ROIs are sampled in one gather program from an
HBM-resident frame (BASELINE.json north star: "frame decode and ROI patch
extraction feed HBM-resident tensors"), so the per-frame step never leaves
the device.

Boxes are (cx, cy, w, h) in pixels, float32.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, ys: jnp.ndarray,
                    xs: jnp.ndarray) -> jnp.ndarray:
    """Sample img [H, W] at float coords (ys, xs) [T, S] x [T, S] → [T, S, S].

    Coordinates are clamped to the frame (border-replicate padding, matching
    the reference's edge handling for ROIs that overrun the frame).

    Row formulation: gather whole frame ROWS per sample row (contiguous
    reads), lerp the row pairs, then gather columns WITHIN each track's
    small row block where locality is high.
    """
    h, w = img.shape
    ys = jnp.clip(ys, 0.0, h - 1.0)
    xs = jnp.clip(xs, 0.0, w - 1.0)
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = (ys - y0)[:, :, None]                       # [T, S, 1]
    fx = (xs - x0)[:, None, :]                       # [T, 1, S]
    y0 = y0.astype(jnp.int32)
    x0 = x0.astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)

    # 1. Row gather (contiguous last axis): [T, S, W] twice, lerp in y.
    r0 = img[y0]                                     # [T, S, W]
    r1 = img[y1]
    rows = r0 * (1.0 - fy) + r1 * fy                 # [T, S, W]

    # 2. Column gather within each [S, W] block: take_along_axis on the
    #    minor axis, then lerp in x.
    c0 = jnp.take_along_axis(rows, jnp.broadcast_to(
        x0[:, None, :], rows.shape[:2] + (x0.shape[1],)), axis=2)
    c1 = jnp.take_along_axis(rows, jnp.broadcast_to(
        x1[:, None, :], rows.shape[:2] + (x1.shape[1],)), axis=2)
    return c0 * (1.0 - fx) + c1 * fx


def extract_patches(img: jnp.ndarray, boxes: jnp.ndarray, padding: float,
                    size: int, scales: jnp.ndarray | None = None
                    ) -> jnp.ndarray:
    """Extract per-track context windows resized to [size, size].

    img    : [H, W] float32 single-channel frame.
    boxes  : [T, 4] (cx, cy, w, h).
    padding: context factor — the window spans padding * (w, h).
    scales : optional [T] per-track extra scale factor (scale pyramid).

    Returns [T, size, size] float32.  Degenerate boxes (w or h <= 0, e.g.
    dead track slots) are clamped to 1 px so the gather stays in-bounds and
    produces finite values — masking discipline per SURVEY.md §7(b).
    """
    cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    w = jnp.maximum(w, 1.0)
    h = jnp.maximum(h, 1.0)
    if scales is not None:
        w = w * scales
        h = h * scales
    win_w = w * padding                               # [T]
    win_h = h * padding
    # Pixel-center sampling: u in {0..size-1} → offset (u + .5)/size - .5.
    u = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size - 0.5
    ys = cy[:, None] + u[None, :] * win_h[:, None]    # [T, S]
    xs = cx[:, None] + u[None, :] * win_w[:, None]
    return bilinear_sample(img, ys, xs)


def to_gray(frame: jnp.ndarray) -> jnp.ndarray:
    """Frame [H, W] / [H, W, 1] / [H, W, 3] (uint8 or float) → [H, W]
    float32 in [0, 1]."""
    f = frame.astype(jnp.float32)
    if f.ndim == 3:
        if f.shape[-1] == 3:
            # ITU-R BT.601 luma, matching OpenCV's RGB→gray.
            f = (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2])
        else:
            f = f[..., 0]
    if frame.dtype == jnp.uint8:
        f = f / 255.0
    return f
