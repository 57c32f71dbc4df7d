"""Detector API: preprocess → YOLO forward → decode → NMS, one jitted
program per frame batch; plus darknet .weights loading.

Replaces the reference's Python/TensorFlow detector wrapper (SURVEY.md §1
L4, §3.4): `detect(frame) → boxes` with preprocessing (resize/normalize)
and postprocessing (anchor decode + NMS) all on device, and the output
already padded to the tracker's static detection capacity.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from jaxmot.models import yolo
from jaxmot.models.yolo import (YoloSpec, decode_head,
                                resolved_stem as _resolved_stem)
from jaxmot.ops.nms import nms_classwise


@functools.partial(jax.jit,
                   static_argnames=("spec", "max_out", "iou_thr",
                                    "score_thr", "frame_hw", "nms_impl",
                                    "pre_top_k"))
def detect_batch(params, frames: jnp.ndarray, spec: YoloSpec,
                 frame_hw: tuple, max_out: int = 64,
                 iou_thr: float = 0.45, score_thr: float = 0.3,
                 nms_impl: str = "greedy", pre_top_k: int | None = None):
    """frames [B, H, W] or [B, H, W, 3] (uint8/float) → padded detections.

    Returns (dets [B, max_out, 5] (cx, cy, w, h, score) in FRAME pixels,
             valid [B, max_out] bool, classes [B, max_out] int32).
    nms_impl: "greedy" (exact up to the top-K prefilter contract on
    ops.nms.nms) or "fast" (parallel; see ops.nms.fast_nms).
    pre_top_k: NMS candidate prefilter; pass a value >= the anchor count
    for unconditionally exact greedy NMS.
    """
    # Preprocess, two exactness-preserving cuts: (a) gray input is
    # resized as ONE channel and broadcast after — bilinear resize is
    # per-channel, so this is element-identical to resizing replicated
    # channels at a third of the work; (b) when the net itself computes
    # in bf16 (conv1 quantizes its input to bf16 regardless), the resize
    # arithmetic runs in bf16 too.
    pre_dtype = jnp.bfloat16 if spec.dtype == "bfloat16" else jnp.float32
    f = frames.astype(pre_dtype)
    if frames.dtype == jnp.uint8:
        f = f / 255.0
    h, w = frame_hw
    s = spec.input_size
    if f.ndim == 3:
        f = jax.image.resize(f, (f.shape[0], s, s), "bilinear")
        if _resolved_stem(spec, hw=(s, s)) == "s2d4":
            # The s2d stem folds its first kernel over Cin for
            # replicated channels (yolo._Pass.s2d_block gray path),
            # so a gray frame feeds the net as ONE channel — the
            # 3-channel broadcast is never materialized.
            f = f[..., None].astype(jnp.float32)
        else:
            f = jnp.repeat(f[..., None], 3, axis=-1).astype(jnp.float32)
    else:
        f = jax.image.resize(f, (f.shape[0], s, s, 3),
                             "bilinear").astype(jnp.float32)

    heads = yolo.apply(params, f, spec)

    all_boxes, all_scores, all_classes = [], [], []
    for head, anchors, stride in zip(heads, spec.anchors, spec.strides):
        bx, sc, cl = decode_head(head, anchors, stride, spec.num_classes,
                                 s, cls_act=spec.cls_activation)
        all_boxes.append(bx)
        all_scores.append(sc)
        all_classes.append(cl)
    boxes = jnp.concatenate(all_boxes, axis=1)      # [B, N, 4] in 416-space
    scores = jnp.concatenate(all_scores, axis=1)
    classes = jnp.concatenate(all_classes, axis=1)
    # Back to frame pixels.
    boxes = boxes * jnp.asarray([w / s, h / s, w / s, h / s], jnp.float32)

    def one(bx, sc, cl):
        idx, valid = nms_classwise(bx, sc, cl, max_out, iou_thr, score_thr,
                                   impl=nms_impl, pre_top_k=pre_top_k)
        safe = jnp.clip(idx, 0, bx.shape[0] - 1)
        out_boxes = bx[safe]
        out_scores = jnp.where(valid, sc[safe], 0.0)
        dets = jnp.concatenate([out_boxes, out_scores[:, None]], axis=1)
        return dets, valid, jnp.where(valid, cl[safe], -1)

    return jax.vmap(one)(boxes, scores, classes)


def dets_with_classes(dets: jnp.ndarray, classes: jnp.ndarray):
    """[..., D, 5] detections + [..., D] int class ids → [..., D, 6].

    The 6-column form is what tracker.step consumes for class-aware
    association (cfg.class_aware); column 5 round-trips through float32
    exactly for class ids < 2^24.
    """
    return jnp.concatenate(
        [dets, classes[..., None].astype(dets.dtype)], axis=-1)


class YoloDetector:
    """Host-facing detector with the reference wrapper's surface.

    >>> det = YoloDetector.random_init(YoloSpec("yolov3-tiny"), seed=0)
    >>> dets, valid, classes = det.detect(frames)        # [B, H, W(,3)]
    """

    def __init__(self, spec: YoloSpec, params, max_out: int = 64,
                 iou_thr: float = 0.45, score_thr: float = 0.3,
                 nms_impl: str = "greedy"):
        self.spec = spec
        self.params = params
        self.max_out = max_out
        self.iou_thr = iou_thr
        self.score_thr = score_thr
        self.nms_impl = nms_impl

    @classmethod
    def random_init(cls, spec: YoloSpec, seed: int = 0, **kw):
        return cls(spec, yolo.init_variables(spec, jax.random.PRNGKey(seed)),
                   **kw)

    @classmethod
    def from_darknet(cls, spec: YoloSpec, weights_path: str, **kw):
        params = load_darknet_weights(spec, weights_path)
        return cls(spec, params, **kw)

    def detect(self, frames):
        frames = jnp.asarray(frames)
        squeeze = frames.ndim in (2, 3) and (
            frames.ndim == 2 or frames.shape[-1] in (1, 3))
        if frames.ndim == 2 or (frames.ndim == 3 and
                                frames.shape[-1] in (1, 3)):
            frames = frames[None]
        hw = (int(frames.shape[1]), int(frames.shape[2]))
        dets, valid, classes = detect_batch(
            self.params, frames, self.spec, hw, self.max_out,
            self.iou_thr, self.score_thr, self.nms_impl)
        if squeeze:
            return (np.asarray(dets[0]), np.asarray(valid[0]),
                    np.asarray(classes[0]))
        return np.asarray(dets), np.asarray(valid), np.asarray(classes)

    # -- checkpointing (SURVEY.md §5) ----------------------------------
    def save(self, path: str) -> None:
        flat = jax.tree_util.tree_flatten_with_path(self.params)[0]
        np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                          for k, v in flat})

    @classmethod
    def load(cls, spec: YoloSpec, path: str, **kw):
        det = cls.random_init(spec, **kw)
        data = np.load(path)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(det.params)
        new = [jnp.asarray(data[jax.tree_util.keystr(k)])
               for k, _ in leaves]
        det.params = jax.tree_util.tree_unflatten(treedef, new)
        return det


def _conv_layers_in_call_order(spec: YoloSpec):
    """Darknet serializes weights in layer order; parameter names follow
    the construction order in yolo.py.  Returns the block names in the
    darknet file order with their (use_bn) flags."""
    if spec.name == "yolov3-tiny":
        # Construction order in yolo._yolov3_tiny == darknet layer order:
        # convs 16..1024 + 256(1x1) are ConvBlock_0..7, then 512 head-conv
        # (ConvBlock_8), head0, 128(1x1) (ConvBlock_9), 256 (ConvBlock_10),
        # head1.
        order = ([f"ConvBlock_{i}" for i in range(9)]
                 + ["head0", "ConvBlock_9", "ConvBlock_10", "head1"])
        bn = [True] * 9 + [False, True, True, False]
        return list(zip(order, bn))
    if spec.name == "yolov2-tiny":
        names = [f"ConvBlock_{i}" for i in range(8)] + ["head0"]
        return list(zip(names, [True] * 8 + [False]))
    if spec.name == "yolov2":
        # darknet-19 backbone (18 convs) + detection convs 19/20, the
        # 64-ch 1x1 passthrough conv, the post-concat 1024 conv, then the
        # linear head — exactly the darknet cfg serialization order,
        # which yolo._yolov2 reproduces as its construction order.
        names = [f"ConvBlock_{i}" for i in range(22)] + ["head0"]
        return list(zip(names, [True] * 22 + [False]))
    if spec.name == "yolov3":
        # darknet-53 (52 convs) + convset A (5) + 1024 pre-head conv,
        # head0; 256 1x1 upsample conv, convset B (5), 512 pre-head conv,
        # head1; 128 1x1 upsample conv, convset C (5), 256 pre-head conv,
        # head2.  75 convs total in cfg order; the explicit head names
        # do not consume the ConvBlock numbering, so ConvBlock_{0..71} are
        # the 72 BN convs in construction order.
        order = ([(f"ConvBlock_{i}", True) for i in range(58)]
                 + [("head0", False)]
                 + [(f"ConvBlock_{i}", True) for i in range(58, 65)]
                 + [("head1", False)]
                 + [(f"ConvBlock_{i}", True) for i in range(65, 72)]
                 + [("head2", False)])
        return order
    raise ValueError(spec.name)


def load_darknet_weights(spec: YoloSpec, path: str):
    """Parse a darknet .weights file into {"params", "batch_stats"}.

    Format: int32 header (major, minor, revision, seen[, ...]) followed by
    flat float32 arrays per conv layer: [bn_beta, bn_gamma, bn_mean,
    bn_var] (or bias when no BN), then conv kernel in OIHW order.
    """
    det = YoloDetector.random_init(spec)
    params = jax.tree.map(np.asarray, det.params)
    with open(path, "rb") as f:
        major, minor, _rev = np.fromfile(f, np.int32, 3)
        if major * 10 + minor >= 2:
            np.fromfile(f, np.int64, 1)     # seen
        else:
            np.fromfile(f, np.int32, 1)
        data = np.fromfile(f, np.float32)

    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos:pos + n]
        if len(out) != n:
            raise ValueError("darknet weight file truncated")
        pos += n
        return out

    for name, use_bn in _conv_layers_in_call_order(spec):
        conv = params["params"][name]["conv"]
        kshape = conv["kernel"].shape                  # HWIO
        kh, kw, ci, co = kshape
        if use_bn:
            bn = params["params"][name]["bn"]
            stats = params["batch_stats"][name]["bn"]
            bn["bias"] = take(co)
            bn["scale"] = take(co)
            stats["mean"] = take(co)
            stats["var"] = take(co)
        else:
            conv["bias"] = take(co)
        w = take(kh * kw * ci * co).reshape(co, ci, kh, kw)
        conv["kernel"] = np.transpose(w, (2, 3, 1, 0))  # OIHW → HWIO
    if pos != len(data):
        raise ValueError(f"darknet weight file has {len(data) - pos} "
                         "unconsumed floats — topology mismatch")
    det_params = jax.tree.map(jnp.asarray, params)
    return det_params
