"""Detector training: data-parallel YOLO train step over a device mesh.

The reference ships pretrained TF weights and has no training loop; a
complete framework needs one to own its detector end to end.  The step is
standard YOLO supervision (objectness BCE + responsible-cell box regression
+ class CE) with optax, expressed as one jit over a batch-sharded mesh:
params replicated, batch split over "batch", XLA inserts the gradient
all-reduce (no hand-written collectives — SURVEY.md §5 "Distributed
comm backend").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from jaxmot.models import yolo
from jaxmot.models.yolo import YoloSpec


def build_targets(spec: YoloSpec, gt_boxes, gt_classes, gt_valid):
    """Ground truth → per-head dense target tensors (host-side, NumPy).

    gt_boxes   : [B, M, 4] (cx, cy, w, h) in input_size pixels
    gt_classes : [B, M] int
    gt_valid   : [B, M] bool
    Returns list over heads of tgt [B, Hg, Wg, A, 5+C].
    Assignment: the anchor with closest area at the object's cell.

    Fully vectorized scatter (one fancy-index assignment per field) — the
    per-GT Python loop this replaces ran on the host every training step.
    When two GTs collide on the same (cell, anchor), the later GT wins the
    box/objectness fields and both class bits stay set, matching the loop
    formulation's sequential overwrite semantics (asserted equivalent in
    tests/test_train.py).
    """
    import numpy as np

    gt_boxes = np.asarray(gt_boxes, np.float32)
    gt_classes = np.asarray(gt_classes, np.int64)
    gt_valid = np.asarray(gt_valid, bool)
    s = spec.input_size
    b, m = gt_valid.shape
    bi, mi = np.nonzero(gt_valid)                      # [K] valid GT list
    # Clamp centers into the frame: a slightly off-frame GT (augmentation
    # jitter) would floor-divide to -1 and numpy fancy indexing would
    # silently wrap the target to the opposite image edge.
    cx = np.clip(gt_boxes[bi, mi, 0], 0.0, s - 1e-3)
    cy = np.clip(gt_boxes[bi, mi, 1], 0.0, s - 1e-3)
    w, h = gt_boxes[bi, mi, 2], gt_boxes[bi, mi, 3]
    cls = gt_classes[bi, mi]
    out = []
    for anchors, stride in zip(spec.anchors, spec.strides):
        hg = wg = s // stride
        a = len(anchors)
        anc = np.asarray(anchors, np.float32)          # [A, 2]
        areas = anc[:, 0] * anc[:, 1]
        tgt = np.zeros((b, hg, wg, a, 5 + spec.num_classes), np.float32)
        gx = np.minimum((cx // stride).astype(np.int64), wg - 1)
        gy = np.minimum((cy // stride).astype(np.int64), hg - 1)
        ai = np.argmin(np.abs(areas[None, :] - (w * h)[:, None]), axis=1)
        tgt[bi, gy, gx, ai, 0] = cx / stride - gx
        tgt[bi, gy, gx, ai, 1] = cy / stride - gy
        tgt[bi, gy, gx, ai, 2] = np.log(np.maximum(w, 1.0) / anc[ai, 0])
        tgt[bi, gy, gx, ai, 3] = np.log(np.maximum(h, 1.0) / anc[ai, 1])
        tgt[bi, gy, gx, ai, 4] = 1.0
        tgt[bi, gy, gx, ai, 5 + cls] = 1.0
        out.append(tgt)
    return out


def yolo_loss(params, batch_stats, images, targets, spec: YoloSpec,
              train: bool = False):
    """Multi-head YOLO loss; targets from build_targets.

    With train=True BatchNorm normalizes with batch statistics and the
    updated running stats are returned as the aux output (loss, stats).
    """
    variables = {"params": params, "batch_stats": batch_stats}
    if train:
        heads, new_stats = yolo.apply(variables, images, spec, train=True)
    else:
        heads = yolo.apply(variables, images, spec)
    total = 0.0
    for raw, tgt in zip(heads, targets):
        b, hg, wg, _ = raw.shape
        a = tgt.shape[3]
        raw = raw.reshape(b, hg, wg, a, -1)
        obj_tgt = tgt[..., 4]
        obj_logit = raw[..., 4]
        obj_loss = optax.sigmoid_binary_cross_entropy(obj_logit,
                                                      obj_tgt).mean()
        mask = obj_tgt[..., None]
        xy_loss = (jnp.square(jax.nn.sigmoid(raw[..., 0:2]) - tgt[..., 0:2])
                   * mask).sum() / jnp.maximum(mask.sum(), 1.0)
        wh_loss = (jnp.square(raw[..., 2:4] - tgt[..., 2:4])
                   * mask).sum() / jnp.maximum(mask.sum(), 1.0)
        cls_logits = raw[..., 5:]
        cls_tgt = tgt[..., 5:]
        # Class link function matches decode (spec.cls_activation): v2
        # heads train softmax-CE, v3 heads independent per-class BCE.
        if spec.cls_activation == "sigmoid":
            cls_ce = optax.sigmoid_binary_cross_entropy(
                cls_logits, cls_tgt).mean(-1)
        else:
            cls_ce = optax.softmax_cross_entropy(cls_logits, cls_tgt)
        cls_loss = ((cls_ce * obj_tgt).sum()
                    / jnp.maximum(obj_tgt.sum(), 1.0))
        total = total + obj_loss + 5.0 * (xy_loss + wh_loss) + cls_loss
    if train:
        return total, new_stats
    return total


def make_train_step(spec: YoloSpec, tx: optax.GradientTransformation):
    """Returns jitted train_step(state, images, targets) → (state, loss).

    state = (params, batch_stats, opt_state).  With images sharded over a
    "batch" mesh axis and params replicated, the same step is single-chip
    or multi-chip DP — GSPMD adds the grad all-reduce.
    """
    @jax.jit
    def train_step(state, images, targets):
        params, batch_stats, opt_state = state
        # has_aux carries the BatchNorm running statistics explicitly:
        # the forward pass returns the updated stats beside the loss.
        (loss, batch_stats), grads = jax.value_and_grad(
            yolo_loss, has_aux=True)(
            params, batch_stats, images, targets, spec, True)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, batch_stats, opt_state), loss

    return train_step


def init_train_state(spec: YoloSpec, tx: optax.GradientTransformation,
                     seed: int = 0):
    var = yolo.init_variables(spec, jax.random.PRNGKey(seed), train=True)
    params = var["params"]
    batch_stats = var["batch_stats"]
    return (params, batch_stats, tx.init(params))
