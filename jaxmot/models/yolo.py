"""JAX YOLO detector family — the reference's TF-wrapped CNN, re-served
as a native JAX model (BASELINE.json north star: "the YOLO CNN detector is
re-served as a JAX model replacing the TensorFlow wrapper").

Four family members cover the reference's detector class (SURVEY.md §2 row
"detector (YOLO)"):

  * yolov3      — full darknet-53 backbone, three heads (stride 32/16/8).
  * yolov3_tiny — the standard 13-conv two-head tiny variant (darknet
    layout, so public .weights files load via models.detector).
  * yolov2      — full darknet-19 + passthrough (reorg) single head; the
    darkflow-served model class the reference wraps in TensorFlow.
  * yolov2_tiny — single-head darkflow-era tiny variant.

Class activation follows the lineage: v2-family heads use a softmax over
classes, v3-family heads use independent per-class sigmoids (the darknet
"logistic" classifier switch) — threaded through decode and the training
loss via YoloSpec.cls_activation.

All convs run in NHWC with optional bfloat16 compute; decode and NMS run
on device so detect() is one jitted program per frame batch.

The networks are plain functions over a parameter pytree:
``init_variables(spec, key)`` builds ``{"params", "batch_stats"}`` and
``apply(variables, x, spec)`` runs the forward pass.  Parameter names
follow the darknet layer order: BatchNorm conv blocks are
``ConvBlock_<i>`` in construction order, the linear heads ``head<k>``;
each block holds ``{"conv": {"kernel"[, "bias"]}, "bn": {"scale",
"bias"}}`` and its running statistics ``{"bn": {"mean", "var"}}`` under
``batch_stats`` (models/detector.load_darknet_weights relies on this).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Canonical anchor sets (pixels at the native 416x416 input), public YOLO
# releases.
YOLOV3_TINY_ANCHORS = (
    ((81, 82), (135, 169), (344, 319)),      # head 0, stride 32
    ((10, 14), (23, 27), (37, 58)),          # head 1, stride 16
)
YOLOV2_TINY_ANCHORS = (
    ((18.3, 21.6), (59.9, 66.0), (106.8, 175.5), (252.2, 112.9),
     (312.2, 293.4)),                        # single head, stride 32
)
# Full v2 shares the v2 anchor set (darknet publishes them in grid units;
# these are the same values scaled by stride 32 into input pixels).
YOLOV2_ANCHORS = YOLOV2_TINY_ANCHORS
YOLOV3_ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),     # head 0, stride 32
    ((30, 61), (62, 45), (59, 119)),         # head 1, stride 16
    ((10, 13), (16, 30), (33, 23)),          # head 2, stride 8
)


_CANONICAL_ANCHORS = {
    "yolov3": YOLOV3_ANCHORS,
    "yolov3-tiny": YOLOV3_TINY_ANCHORS,
    "yolov2": YOLOV2_ANCHORS,
    "yolov2-tiny": YOLOV2_TINY_ANCHORS,
}


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    name: str
    num_classes: int = 80
    input_size: int = 416
    # None → the variant's canonical anchor set (resolved in __post_init__);
    # pass an explicit per-head tuple-of-tuples to override.
    anchors: tuple | None = None
    # Conv compute dtype: "float32", "bfloat16" (bf16 operands, the
    # serving choice where a trained net's mAP allows it) or "int8"
    # (post-training dynamic quantization of the same f32 parameters:
    # per-output-channel int8 weights, per-sample int8 activations,
    # int32 accumulation; inference only, direct stem).
    dtype: str = "float32"
    # BatchNorm running-stats momentum: 0.99 matches darknet for long
    # training runs; small/fast fine-tunes want ~0.9 so the running
    # stats converge to the batch stats the train-mode network learned
    # against (the train/eval gap at 0.99 needs thousands of steps to
    # close).
    bn_momentum: float = 0.99
    # Early-layer formulation.  "direct" = the darknet composition
    # (conv Cin=3 @ full res -> pool -> conv -> pool).  "s2d4" = the
    # exact space-to-depth rewrite: the whole stem runs on the
    # (input/4)^2 grid with the conv taps scattered into
    # (cell-offset, subpixel) kernel slots and the maxpools collapsed
    # to channel-group maxes — same math, wider channel counts for the
    # matrix units.  The parameter tree is IDENTICAL to "direct" (the
    # scatter is an apply-time transform of the canonical kernels), so
    # darknet .weights and checkpoints are stem-agnostic and a net can
    # train "direct" and serve "s2d4".  Inference-only (supported:
    # yolov3-tiny, yolov2-tiny, yolov2 — the pooled-stem variants;
    # yolov3's strided convs have no pool to collapse).  "auto" (the
    # default) resolves per apply: s2d4 whenever it is supported and
    # the call is inference, else direct.  resolved_stem() is the one
    # resolution point.
    stem: str = "auto"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown dtype {self.dtype!r}; "
                             "have ('float32', 'bfloat16', 'int8')")
        if self.stem not in ("auto", "direct", "s2d4"):
            raise ValueError(f"unknown stem {self.stem!r}; "
                             "have ('auto', 'direct', 's2d4')")
        if self.stem == "s2d4":
            if self.name == "yolov3":
                raise ValueError("yolov3's strided-conv stem has no pools "
                                 "to collapse; stem='s2d4' supports the "
                                 "pooled variants (yolov3-tiny, yolov2, "
                                 "yolov2-tiny)")
            if self.dtype == "int8":
                raise ValueError("stem='s2d4' is implemented for the "
                                 "f32/bf16 conv path (int8 serves the "
                                 "direct stem)")
        if self.anchors is None:
            if self.name not in _CANONICAL_ANCHORS:
                raise ValueError(
                    f"unknown yolo variant {self.name!r}; have "
                    f"{sorted(_CANONICAL_ANCHORS)} (or pass anchors=)")
            object.__setattr__(self, "anchors",
                               _CANONICAL_ANCHORS[self.name])

    @property
    def strides(self) -> tuple:
        return (32, 16, 8)[: len(self.anchors)]

    @property
    def cls_activation(self) -> str:
        """Per-lineage class activation: v3 heads score classes with
        independent sigmoids (darknet's logistic switch), v2 heads with a
        softmax.  Used by both decode_head and the training loss so the
        model trains against the same link function it is decoded with."""
        return "sigmoid" if self.name.startswith("yolov3") else "softmax"


def _compute_dtype(spec):
    return jnp.bfloat16 if spec.dtype == "bfloat16" else jnp.float32


def conv2d(x, w, stride: int = 1, dtype=jnp.float32):
    """NHWC x HWIO convolution with darknet padding.

    darknet pads k//2 on BOTH sides.  XLA's "SAME" agrees at stride 1
    but pads (0, 1) at stride 2, sampling one pixel later than darknet's
    (1, 1) — a spatial shift that compounds across the full-v3 backbone's
    five downsample convs and misaligns pretrained .weights activations
    against the grid decode.  Explicit symmetric padding is darknet-exact
    at every stride."""
    pad = w.shape[0] // 2
    return jax.lax.conv_general_dilated(
        x.astype(dtype), w.astype(dtype), (stride, stride),
        ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def conv2d_int8(x, w, stride: int = 1):
    """conv2d with both operands quantized to int8 and int32
    accumulation, rescaled to f32.

    Weights: symmetric per output channel.  Activations: symmetric per
    SAMPLE, so a bright frame does not coarsen its batchmates' grid and
    batched serving equals streaming frame by frame.  round() has zero
    gradient, so this path is inference-only."""
    s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-8)
    wq = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
    x = x.astype(jnp.float32)
    s_x = jnp.maximum(
        jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-8)
    xq = jnp.clip(jnp.round(x / s_x), -127, 127).astype(jnp.int8)
    pad = w.shape[0] // 2
    y = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return y.astype(jnp.float32) * (s_x * s_w)


def _leaky(x):
    return jnp.where(x > 0, x, 0.1 * x)


@functools.lru_cache(maxsize=None)
def _s2d_scatter(s: int) -> np.ndarray:
    """0/1 placement tensor for the space-to-depth kernel rewrite.

    A 3x3 stride-1 conv on X equals a 3x3 conv on s2d(X) with each tap
    (u, v) scattered into a (cell-tap, subpixel-block, cell-offset-block)
    slot: output block q = ey*s+ex of a cell is the conv output at pixel
    (s*I+ey, s*J+ex); tap (u, v) reads pixel offset a = ey+u-1, which
    lives at cell offset divmod(a, s)[0] and subpixel block
    divmod(a, s)[1].  Cell-level zero padding reproduces SAME padding
    exactly (taps never reach beyond one pixel outside the frame).
    Returns S[u, v, a, b, p, q] in {0, 1} with p = dy*s+dx, q = ey*s+ex;
    the scattered kernel is einsum('uvabpq,uvio->abpiqo', S, w)
    reshaped to [3, 3, s*s*Cin, s*s*Co].  (u, a, ey, ...) determine each
    other uniquely, so no two taps share a slot and placement is exact
    (exactness asserted by tests/test_stem.py).
    """
    m = np.zeros((3, 3, 3, 3, s * s, s * s), np.float32)
    for ey in range(s):
        for ex in range(s):
            for u in range(3):
                for v in range(3):
                    da, dy = divmod(ey + u - 1, s)
                    db, dx = divmod(ex + v - 1, s)
                    m[u, v, da + 1, db + 1, dy * s + dx, ey * s + ex] = 1.0
    return m


def _scatter_kernel(w: jnp.ndarray, s: int) -> jnp.ndarray:
    """Apply-time s2d rewrite of a [3, 3, Cin, Co] kernel →
    [3, 3, s²·Cin, s²·Co] (see _s2d_scatter)."""
    cin, co = w.shape[2], w.shape[3]
    out = jnp.einsum("uvabpq,uvio->abpiqo",
                     jnp.asarray(_s2d_scatter(s), w.dtype), w)
    return out.reshape(3, 3, s * s * cin, s * s * co)


def resolved_stem(spec: "YoloSpec", train: bool = False,
                  hw=None) -> str:
    """Resolve spec.stem="auto" for one apply: the s2d4 rewrite whenever
    it is supported (pooled-stem variants, input H/W divisible by 4)
    and the call is inference; the direct composition for training,
    int8, yolov3 (whose strided stem has no pools to collapse), and odd
    input extents — a DEFAULT nobody opted
    into must never turn a previously-valid shape into a trace error.
    Explicit "direct"/"s2d4" pass through (s2d4's support constraints
    were validated by YoloSpec.__post_init__; an explicit s2d4 on an
    indivisible shape still raises in _stem_s2d4)."""
    if spec.stem != "auto":
        return spec.stem
    if train or spec.dtype == "int8" or spec.name == "yolov3":
        return "direct"
    if hw is not None and (hw[0] % 4 or hw[1] % 4):
        return "direct"
    return "s2d4"


class _Pass:
    """One forward pass over a parameter pytree (see the module docstring
    for the tree's layout).

    With ``key`` set the pass creates every leaf it reads (initial
    values: LeCun-normal kernels, zero biases, unit BatchNorm scale and
    variance).  With ``train=True`` BatchNorm normalizes with the batch
    statistics and collects the updated running statistics in
    ``new_stats``; inference uses the stored running statistics.
    """

    def __init__(self, spec: YoloSpec, params, stats, train: bool = False,
                 key=None):
        if train and spec.dtype == "int8":
            raise ValueError(
                "spec.dtype='int8' is an inference-only path (the "
                "quantization round() has zero gradient); train in "
                "float32/bfloat16 and serve the same params as int8")
        self.spec = spec
        self.params = params
        self.stats = stats
        self.train = train
        self.key = key
        self.new_stats = {}
        self.dtype = _compute_dtype(spec)
        self._n_auto = 0

    def _leaf(self, tree, path, shape, init):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {}) if self.key is not None else node[k]
        if self.key is not None and path[-1] not in node:
            self.key, sub = jax.random.split(self.key)
            node[path[-1]] = init(sub, shape, jnp.float32)
        return node[path[-1]]

    def _kernel(self, name, shape):
        return self._leaf(self.params, (name, "conv", "kernel"), shape,
                          jax.nn.initializers.lecun_normal())

    def _batch_norm(self, name, y, features, tile: int = 1):
        """BatchNorm over the canonical `features` channels; `tile` > 1
        repeats the per-channel parameters across s2d cell-offset
        blocks."""
        zeros = jax.nn.initializers.zeros
        ones = jax.nn.initializers.ones
        scale = self._leaf(self.params, (name, "bn", "scale"), (features,),
                           ones)
        bias = self._leaf(self.params, (name, "bn", "bias"), (features,),
                          zeros)
        mean = self._leaf(self.stats, (name, "bn", "mean"), (features,),
                          zeros)
        var = self._leaf(self.stats, (name, "bn", "var"), (features,), ones)
        if self.train:
            yf = y.astype(jnp.float32)
            m = jnp.mean(yf, axis=(0, 1, 2))
            v = jnp.maximum(jnp.mean(yf * yf, axis=(0, 1, 2)) - m * m, 0.0)
            mom = self.spec.bn_momentum
            self.new_stats[name] = {"bn": {
                "mean": mom * mean + (1.0 - mom) * m,
                "var": mom * var + (1.0 - mom) * v}}
            mean, var = m, v
        rep = lambda p: jnp.tile(p, tile) if tile > 1 else p
        mul = rep(jax.lax.rsqrt(var + 1e-5) * scale)
        return ((y - rep(mean)) * mul + rep(bias)).astype(self.dtype)

    def block(self, x, features: int, kernel: int = 3, stride: int = 1,
              use_bn: bool = True, act: bool = True, name: str | None = None):
        """Conv + BatchNorm + LeakyReLU — darknet's standard block (a
        linear head with use_bn=act=False and a conv bias)."""
        if name is None:
            name = f"ConvBlock_{self._n_auto}"
            self._n_auto += 1
        w = self._kernel(name, (kernel, kernel, x.shape[-1], features))
        if self.spec.dtype == "int8":
            y = conv2d_int8(x, w, stride)
        else:
            y = conv2d(x, w, stride, self.dtype)
        if not use_bn:
            b = self._leaf(self.params, (name, "conv", "bias"), (features,),
                           jax.nn.initializers.zeros)
            y = y + b.astype(y.dtype)
        else:
            y = self._batch_norm(name, y, features)
        return _leaky(y) if act else y

    def s2d_block(self, x, features: int, cells: int, cin: int):
        """Space-to-depth formulation of a 3x3 stride-1 conv+BN+leaky
        block: the conv runs on the packed [B, H/s, W/s, s²·Cin] grid
        against the scattered kernel (placement proof in _s2d_scatter);
        BN parameters tile s²× across the cell-offset blocks.  The
        declared kernel keeps the direct shape [3, 3, cin, features], so
        the parameter tree is shared with the direct stem.  Inference
        only: batch statistics in packed space would need the
        per-position reduction, which nothing serving needs."""
        if self.train:
            raise ValueError(
                "stem='s2d4' is inference-only; train with stem='direct'"
                " (identical parameters) and serve with s2d4")
        name = f"ConvBlock_{self._n_auto}"
        self._n_auto += 1
        w = self._kernel(name, (3, 3, cin, features))
        if x.shape[-1] == cells * cells:
            # Gray fast path: the caller packed a single-channel frame,
            # so the canonical Cin channels would all see the same
            # values — fold the kernel over Cin first (exact for
            # replicated channels: conv(repeat(g, C), w) ==
            # conv(g, w.sum(Cin))).
            w = w.sum(axis=2, keepdims=True)
        elif x.shape[-1] != cells * cells * cin:
            raise ValueError(
                f"s2d input has {x.shape[-1]} channels; expected "
                f"{cells * cells} (gray) or {cells * cells * cin}")
        y = conv2d(x, _scatter_kernel(w, cells), 1, self.dtype)
        return _leaky(self._batch_norm(name, y, features,
                                       tile=cells * cells))


def _maxpool(x, stride=2):
    """2x2 max pool, "SAME" padding (darknet's stride-1 pool pads one
    pixel on the bottom/right)."""
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, stride, stride, 1), "SAME")


def _posmax(x, groups):
    """2x2 stride-2 maxpool in s2d-packed space: max over the `groups`
    leading cell-offset blocks per output channel."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).max(axis=3)


def _stem_pool_s4(x, co):
    """First stem maxpool in s2d4-packed space: block index
    (ey*4+ex)·co+o decomposes as ey = 2·py2+dy, ex = 2·px2+dx; a 2x2
    stride-2 maxpool is the max over (dy, dx), and the survivors
    re-pack as the s2d2 block order (py2*2+px2)·co+o the second
    (s=2-scattered) conv kernel expects."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, 2, 2, 2, 2, co)
    x = x.max(axis=(4, 6))
    return x.reshape(b, h, w, 4 * co)


def _stem_s2d4(net: _Pass, x, f1, f2):
    """Space-to-depth rewrite of the pooled YOLO stem:
    conv(3→f1) → pool → conv(f1→f2) → pool, computed entirely on the
    (H/4, W/4) grid.  x is [B, H, W, 1] (gray fast path) or
    [B, H, W, 3]; returns [B, H/4, W/4, f2], exact vs the direct
    composition up to conv accumulation order (tests/test_stem.py)."""
    if x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"s2d4 stem needs H, W divisible by 4; "
                         f"got {x.shape}")
    x = _reorg(x, 4)                       # [B, H/4, W/4, 16·Cin]
    x = net.s2d_block(x, f1, cells=4, cin=3)
    x = _stem_pool_s4(x, f1)               # [B, H/4, W/4, 4·f1]
    x = net.s2d_block(x, f2, cells=2, cin=f1)
    return _posmax(x, 4)                   # [B, H/4, W/4, f2]


def _reorg(x: jnp.ndarray, stride: int = 2) -> jnp.ndarray:
    """YOLOv2 passthrough layer: space-to-depth, [B, H, W, C] →
    [B, H/s, W/s, s*s*C] with output channel k = (dy*s + dx)*C + c.

    This is the ordering the darkflow/pytorch ports of yolov2 use for the
    passthrough route (block-position-major, source-channel-minor).
    darknet's own reorg kernel has a well-known index quirk; the port
    ordering is the one public v2 weight conversions are checked against,
    so it is the right target for load parity [K-class evidence,
    SURVEY.md §0 — no reference file to cite].
    """
    b, h, w, c = x.shape
    s = stride
    x = x.reshape(b, h // s, s, w // s, s, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // s, w // s, s * s * c)


def _head_width(spec, k):
    return len(spec.anchors[k]) * (5 + spec.num_classes)


def _yolov3_tiny(net: _Pass, x):
    """Two-head tiny YOLOv3 (13 convs), darknet-compatible topology."""
    c = net.block
    if resolved_stem(net.spec, net.train, x.shape[1:3]) == "s2d4":
        x = _stem_s2d4(net, x, 16, 32)
    else:
        x = _maxpool(c(x, 16))
        x = _maxpool(c(x, 32))
    x = _maxpool(c(x, 64))
    x = _maxpool(c(x, 128))
    x = c(x, 256)
    route8 = x
    x = _maxpool(x)
    x = c(x, 512)
    x = _maxpool(x, stride=1)
    x = c(x, 1024)
    x = c(x, 256, 1)
    route13 = x
    # Head 0 (stride 32).
    y0 = c(route13, 512)
    y0 = c(y0, _head_width(net.spec, 0), 1, use_bn=False, act=False,
           name="head0")
    # Head 1 (stride 16) with upsample + concat.
    u = c(route13, 128, 1)
    u = jax.image.resize(u, (u.shape[0], u.shape[1] * 2,
                             u.shape[2] * 2, u.shape[3]), "nearest")
    x1 = jnp.concatenate([u, route8], axis=-1)
    y1 = c(x1, 256)
    y1 = c(y1, _head_width(net.spec, 1), 1, use_bn=False, act=False,
           name="head1")
    return (y0.astype(jnp.float32), y1.astype(jnp.float32))


def _yolov2_tiny(net: _Pass, x):
    """Single-head tiny YOLOv2 (9 convs), darkflow-era topology."""
    c = net.block
    if resolved_stem(net.spec, net.train, x.shape[1:3]) == "s2d4":
        x = _stem_s2d4(net, x, 16, 32)
        body = (64, 128, 256)
    else:
        body = (16, 32, 64, 128, 256)
    for f in body:
        x = _maxpool(c(x, f))
    x = c(x, 512)
    x = _maxpool(x, stride=1)
    x = c(x, 1024)
    x = c(x, 512)
    x = c(x, _head_width(net.spec, 0), 1, use_bn=False, act=False,
          name="head0")
    return (x.astype(jnp.float32),)


def _yolov2(net: _Pass, x):
    """Full YOLOv2: darknet-19 backbone + passthrough (reorg) head, built
    in darknet cfg order so ConvBlock_<i> enumerates the .weights file
    order (see detector._conv_layers_in_call_order)."""
    c = net.block
    if resolved_stem(net.spec, net.train, x.shape[1:3]) == "s2d4":
        x = _stem_s2d4(net, x, 32, 64)
    else:
        x = _maxpool(c(x, 32))
        x = _maxpool(c(x, 64))
    x = c(x, 128)
    x = c(x, 64, 1)
    x = _maxpool(c(x, 128))
    x = c(x, 256)
    x = c(x, 128, 1)
    x = _maxpool(c(x, 256))
    x = c(x, 512)
    x = c(x, 256, 1)
    x = c(x, 512)
    x = c(x, 256, 1)
    x = c(x, 512)
    route16 = x                          # stride-16 512-ch feature
    x = _maxpool(x)
    x = c(x, 1024)
    x = c(x, 512, 1)
    x = c(x, 1024)
    x = c(x, 512, 1)
    x = c(x, 1024)
    # Detection block.
    x = c(x, 1024)
    x = c(x, 1024)
    p = c(route16, 64, 1)
    p = _reorg(p)                        # [B, Hg, Wg, 256]
    x = jnp.concatenate([p, x], axis=-1)
    x = c(x, 1024)
    x = c(x, _head_width(net.spec, 0), 1, use_bn=False, act=False,
          name="head0")
    return (x.astype(jnp.float32),)


def _yolov3(net: _Pass, x):
    """Full YOLOv3: darknet-53 backbone, three heads (stride 32/16/8);
    75 conv layers in darknet cfg order (52 backbone + 23 head/neck)."""
    c = net.block

    def res(x, half):
        # darknet-53 residual: 1x1 halve, 3x3 restore, identity add
        # (no activation on the sum — the blocks' leaky relu is it).
        y = c(x, half, 1)
        y = c(y, half * 2)
        return x + y

    x = c(x, 32)
    x = c(x, 64, stride=2)
    x = res(x, 32)
    x = c(x, 128, stride=2)
    for _ in range(2):
        x = res(x, 64)
    x = c(x, 256, stride=2)
    for _ in range(8):
        x = res(x, 128)
    route8 = x                            # stride-8, 256 ch
    x = c(x, 512, stride=2)
    for _ in range(8):
        x = res(x, 256)
    route16 = x                           # stride-16, 512 ch
    x = c(x, 1024, stride=2)
    for _ in range(4):
        x = res(x, 512)

    def convset(x, f):
        for k in (1, 3, 1, 3, 1):
            x = c(x, f if k == 1 else f * 2, k)
        return x

    def upsample2(u):
        return jax.image.resize(
            u, (u.shape[0], u.shape[1] * 2, u.shape[2] * 2, u.shape[3]),
            "nearest")

    # Head 0 (stride 32).
    branch0 = convset(x, 512)
    y0 = c(branch0, 1024)
    y0 = c(y0, _head_width(net.spec, 0), 1, use_bn=False, act=False,
           name="head0")
    # Head 1 (stride 16).
    u = upsample2(c(branch0, 256, 1))
    branch1 = convset(jnp.concatenate([u, route16], axis=-1), 256)
    y1 = c(branch1, 512)
    y1 = c(y1, _head_width(net.spec, 1), 1, use_bn=False, act=False,
           name="head1")
    # Head 2 (stride 8).
    u = upsample2(c(branch1, 128, 1))
    branch2 = convset(jnp.concatenate([u, route8], axis=-1), 128)
    y2 = c(branch2, 256)
    y2 = c(y2, _head_width(net.spec, 2), 1, use_bn=False, act=False,
           name="head2")
    return (y0.astype(jnp.float32), y1.astype(jnp.float32),
            y2.astype(jnp.float32))


_NETS = {"yolov3": (_yolov3, 3), "yolov3-tiny": (_yolov3_tiny, 2),
         "yolov2": (_yolov2, 1), "yolov2-tiny": (_yolov2_tiny, 1)}


def network(spec: YoloSpec):
    """The forward function of spec's variant; checks the anchor groups
    against the variant's head count."""
    if spec.name not in _NETS:
        raise ValueError(f"unknown yolo variant {spec.name!r}")
    fn, n_heads = _NETS[spec.name]
    if len(spec.anchors) != n_heads:
        raise ValueError(
            f"{spec.name} has {n_heads} heads but spec carries "
            f"{len(spec.anchors)} anchor groups (leave anchors=None for "
            f"the canonical set)")
    return fn


def init_variables(spec: YoloSpec, key, input_shape=None,
                   train: bool = False):
    """Fresh {"params", "batch_stats"} for spec.  input_shape (NHWC,
    default [1, input_size, input_size, 3]) only fixes the trace; the
    parameter shapes do not depend on it."""
    fn = network(spec)
    shape = input_shape or (1, spec.input_size, spec.input_size, 3)

    def make(k):
        net = _Pass(spec, {}, {}, train=train, key=k)
        fn(net, jnp.zeros(shape, jnp.float32))
        return {"params": net.params, "batch_stats": net.stats}

    # Traced once and compiled: XLA drops the unused forward pass, so only
    # the random initializers run.
    return jax.jit(make)(key)


def apply(variables, x, spec: YoloSpec, train: bool = False):
    """Forward pass: x [B, H, W, C] → tuple of raw head maps
    [B, H/stride, W/stride, A*(5+classes)] (float32).  With train=True
    BatchNorm uses batch statistics and the result is
    (heads, new_batch_stats)."""
    fn = network(spec)
    net = _Pass(spec, variables["params"], variables.get("batch_stats", {}),
                train=train)
    heads = fn(net, x)
    if train:
        return heads, net.new_stats
    return heads


def decode_head(raw: jnp.ndarray, anchors: Sequence, stride: int,
                num_classes: int, input_size: int,
                cls_act: str = "softmax"):
    """Raw head output [B, Hg, Wg, A*(5+C)] → (boxes [B, N, 4] cxcywh in
    input pixels, scores [B, N], classes [B, N]) with N = Hg*Wg*A.

    Standard YOLOv2/v3 decode: sigmoid xy offset + grid, anchor * exp(wh),
    sigmoid objectness * max-class probability.  cls_act selects the class
    link function ("softmax" = v2 lineage, "sigmoid" = v3's independent
    logistic classifiers — pass spec.cls_activation).
    """
    b, hg, wg, _ = raw.shape
    a = len(anchors)
    raw = raw.reshape(b, hg, wg, a, 5 + num_classes)
    gy = jax.lax.broadcasted_iota(jnp.float32, (hg, wg), 0)
    gx = jax.lax.broadcasted_iota(jnp.float32, (hg, wg), 1)
    anc = jnp.asarray(anchors, jnp.float32)            # [A, 2] pixels

    xy = jax.nn.sigmoid(raw[..., 0:2])
    cx = (gx[None, :, :, None] + xy[..., 0]) * stride
    cy = (gy[None, :, :, None] + xy[..., 1]) * stride
    wh = jnp.exp(jnp.clip(raw[..., 2:4], -10.0, 8.0)) * anc[None, None, None]
    obj = jax.nn.sigmoid(raw[..., 4])
    if num_classes <= 1:
        cls_prob = jnp.ones(raw.shape[:-1] + (1,), jnp.float32)
    elif cls_act == "sigmoid":
        cls_prob = jax.nn.sigmoid(raw[..., 5:])
    else:
        cls_prob = jax.nn.softmax(raw[..., 5:], axis=-1)
    best_cls = jnp.argmax(cls_prob, axis=-1)
    score = obj * jnp.max(cls_prob, axis=-1)

    n = hg * wg * a
    boxes = jnp.stack([cx, cy, wh[..., 0], wh[..., 1]],
                      axis=-1).reshape(b, n, 4)
    return boxes, score.reshape(b, n), best_cls.reshape(b, n)
