"""Space-to-depth stem (YoloSpec.stem="s2d4") — exactness vs the direct
composition, param-tree compatibility, gray fast path, and guard rails.

The stem is the exact MLPerf-style rewrite of conv+pool+conv+pool onto
the (H/4)² grid (models/yolo._s2d_scatter).  Everything here runs CPU
f32, where the only direct-vs-s2d difference is conv accumulation
order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxmot.models.yolo import (YoloSpec, _Pass, _maxpool,
                                _scatter_kernel, _stem_s2d4, apply,
                                init_variables)

VARIANTS = ["yolov3-tiny", "yolov2-tiny", "yolov2"]


def _specs(name):
    # Explicit "direct" baseline: the spec DEFAULT is "auto" (resolves
    # to s2d4 at inference since r5), so the A/B must pin both sides.
    direct = YoloSpec(name, num_classes=4, stem="direct")
    return direct, dataclasses.replace(direct, stem="s2d4")


@pytest.mark.parametrize("name", VARIANTS)
def test_param_tree_identical(name):
    """stem="s2d4" must share the canonical tree byte-for-byte (darknet
    loads and checkpoints are stem-agnostic)."""
    direct, s2d = _specs(name)
    vd = init_variables(direct, jax.random.PRNGKey(0), (1, 96, 96, 3))
    vs = init_variables(s2d, jax.random.PRNGKey(0), (1, 96, 96, 3))
    pd = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), vd)
    ps = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), vs)
    assert pd == ps


@pytest.mark.parametrize("name", VARIANTS)
def test_heads_match_direct(name):
    """Full-model heads from the s2d4 stem match the direct composition
    on the SAME parameters (f32; conv accumulation-order class)."""
    direct, s2d = _specs(name)
    var = init_variables(direct, jax.random.PRNGKey(1), (1, 96, 96, 3))
    x = jnp.asarray(np.random.default_rng(0).random((2, 96, 96, 3)),
                    jnp.float32)
    hd = apply(var, x, direct)
    hs = apply(var, x, s2d)
    for a, b in zip(hd, hs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_stem_block_exact():
    """The isolated stem (conv 3→16 + pool + conv 16→32 + pool) matches
    the direct composition at conv-accumulation tolerance."""
    rng = np.random.default_rng(2)
    spec = YoloSpec("yolov3-tiny", num_classes=1, stem="s2d4")
    var = init_variables(spec, jax.random.PRNGKey(2), (1, 96, 96, 3))
    x = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.float32)

    p0 = var["params"]["ConvBlock_0"]
    p1 = var["params"]["ConvBlock_1"]
    s0 = var["batch_stats"]["ConvBlock_0"]["bn"]
    s1 = var["batch_stats"]["ConvBlock_1"]["bn"]

    def bn_lrelu(y, p, s):
        y = ((y - s["mean"]) * jax.lax.rsqrt(s["var"] + 1e-5)
             * p["bn"]["scale"] + p["bn"]["bias"])
        return jnp.where(y > 0, y, 0.1 * y)

    def conv(y, w):
        return jax.lax.conv_general_dilated(
            y, w, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def pool(y):
        # Plain 2x2 stride-2 max pool (independent of yolo._maxpool).
        b, h, w, c = y.shape
        return y.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))

    ref = pool(bn_lrelu(conv(x, p0["conv"]["kernel"]), p0, s0))
    ref = pool(bn_lrelu(conv(ref, p1["conv"]["kernel"]), p1, s1))

    # Exercise the s2d stem blocks directly with the shared params.
    got = _stem_s2d4(_Pass(spec, var["params"], var["batch_stats"]), x,
                     16, 32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_scatter_kernel_shape_and_energy():
    """Scatter places every tap exactly once: total L1 mass is
    preserved s²× (each tap copied into s² cell-offset blocks)."""
    w = np.random.default_rng(3).normal(size=(3, 3, 5, 7)).astype(np.float32)
    for s in (2, 4):
        out = np.asarray(_scatter_kernel(jnp.asarray(w), s))
        assert out.shape == (3, 3, s * s * 5, s * s * 7)
        np.testing.assert_allclose(np.abs(out).sum(),
                                   s * s * np.abs(w).sum(), rtol=1e-6)


def test_gray_fast_path_matches_broadcast():
    """Feeding a single-channel frame through the s2d stem equals the
    direct model on the 3-channel broadcast (kernel-fold exactness)."""
    direct, s2d = _specs("yolov3-tiny")
    var = init_variables(direct, jax.random.PRNGKey(4), (1, 96, 96, 3))
    g = jnp.asarray(np.random.default_rng(4).random((2, 96, 96)),
                    jnp.float32)
    hd = apply(var, jnp.repeat(g[..., None], 3, -1), direct)
    hs = apply(var, g[..., None], s2d)
    for a, b in zip(hd, hs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_detect_batch_stem_agrees():
    """detect_batch end-to-end (gray frames): same detections from the
    stem and direct specs with shared params."""
    from jaxmot.models.detector import YoloDetector, detect_batch
    direct, s2d = _specs("yolov3-tiny")
    det = YoloDetector.random_init(direct, seed=5)
    frames = (np.random.default_rng(5).random((2, 240, 320)) * 255
              ).astype(np.uint8)
    rd = detect_batch(det.params, jnp.asarray(frames), direct, (240, 320),
                      max_out=8, score_thr=0.0)
    rs = detect_batch(det.params, jnp.asarray(frames), s2d, (240, 320),
                      max_out=8, score_thr=0.0)
    np.testing.assert_allclose(np.asarray(rd[0]), np.asarray(rs[0]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(rd[1]), np.asarray(rs[1]))


def test_guards():
    with pytest.raises(ValueError, match="unknown stem"):
        YoloSpec("yolov3-tiny", stem="s2d8")
    with pytest.raises(ValueError, match="strided-conv"):
        YoloSpec("yolov3", stem="s2d4")
    with pytest.raises(ValueError, match="unknown dtype"):
        YoloSpec("yolov3-tiny", dtype="int4")
    with pytest.raises(ValueError, match="int8"):
        YoloSpec("yolov3-tiny", stem="s2d4", dtype="int8")
    # Inference-only: train=True through the stem raises.
    spec = YoloSpec("yolov3-tiny", num_classes=1, stem="s2d4")
    with pytest.raises(ValueError, match="inference-only"):
        init_variables(spec, jax.random.PRNGKey(0), (1, 96, 96, 3),
                       train=True)


def test_auto_stem_resolution():
    """stem="auto" (the default) = s2d4 at inference on supported
    variants, direct for training / int8 / yolov3."""
    from jaxmot.models.yolo import resolved_stem

    s = YoloSpec("yolov3-tiny", num_classes=4)
    assert s.stem == "auto"
    assert resolved_stem(s) == "s2d4"
    assert resolved_stem(s, train=True) == "direct"
    assert resolved_stem(
        YoloSpec("yolov3-tiny", num_classes=4, dtype="int8")) == "direct"
    assert resolved_stem(YoloSpec("yolov3", num_classes=4)) == "direct"
    assert resolved_stem(
        YoloSpec("yolov2", num_classes=4, dtype="bfloat16")) == "s2d4"
    assert resolved_stem(
        YoloSpec("yolov3-tiny", num_classes=4, stem="direct")) == "direct"
    # Shape fallback: an auto default must never turn a previously-valid
    # non-multiple-of-4 input into a trace error.
    assert resolved_stem(s, hw=(418, 418)) == "direct"
    assert resolved_stem(s, hw=(416, 416)) == "s2d4"


def test_auto_stem_odd_shape_runs_direct():
    """A full model apply on a non-div-4 input under the auto default
    must run (via the direct fallback), not raise.  yolov2-tiny: the
    single-head pooled variant accepts any even-ish extent (yolov3-tiny
    needs /32 for its route concat, so every valid size is /4 there and
    the fallback is moot)."""
    spec = YoloSpec("yolov2-tiny", num_classes=2)
    var = init_variables(spec, jax.random.PRNGKey(0), (1, 96, 96, 3))
    out = apply(var, jnp.zeros((1, 98, 98, 3)), spec)
    assert all(np.isfinite(np.asarray(h)).all() for h in out)
