"""Pairwise IoU and association cost matrix — one broadcast block.

Reference: O(T*D) scalar loop building the cost matrix from IoU and
appearance (SURVEY.md §2 row "iou / cost matrix", §3.2).  Here it is a
single [T, D] broadcast program.
Boxes are (cx, cy, w, h).
"""

from __future__ import annotations

import jax.numpy as jnp


def pairwise_iou(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """IoU matrix [T, D] between box sets a [T, 4] and b [D, 4]."""
    ax1 = a[:, 0] - a[:, 2] / 2
    ay1 = a[:, 1] - a[:, 3] / 2
    ax2 = a[:, 0] + a[:, 2] / 2
    ay2 = a[:, 1] + a[:, 3] / 2
    bx1 = b[:, 0] - b[:, 2] / 2
    by1 = b[:, 1] - b[:, 3] / 2
    bx2 = b[:, 0] + b[:, 2] / 2
    by2 = b[:, 1] + b[:, 3] / 2
    iw = jnp.maximum(0.0, jnp.minimum(ax2[:, None], bx2[None, :])
                     - jnp.maximum(ax1[:, None], bx1[None, :]))
    ih = jnp.maximum(0.0, jnp.minimum(ay2[:, None], by2[None, :])
                     - jnp.maximum(ay1[:, None], by1[None, :]))
    inter = iw * ih
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    union = area_a + area_b - inter
    return jnp.where(union > 0, inter / union, 0.0)


def association_cost(track_boxes: jnp.ndarray, det_boxes: jnp.ndarray,
                     track_valid: jnp.ndarray, det_valid: jnp.ndarray,
                     iou_gate: float, infeasible: float,
                     appearance: jnp.ndarray | None = None,
                     appearance_weight: float = 0.0,
                     class_gate: jnp.ndarray | None = None,
                     track_boxes_alt: jnp.ndarray | None = None
                     ) -> jnp.ndarray:
    """Gated cost matrix [T, D].

    cost = (1-w)*(1 - IoU) + w*(1 - appearance); pairs below the IoU gate,
    or involving a dead track slot / padded detection, get `infeasible`.
    `appearance` is an optional [T, D] similarity in [0, 1] (e.g. the KCF
    response of track t's model at detection d — the reference blends IoU
    with appearance per BASELINE.json north star).  `class_gate` is an
    optional [T, D] bool mask; False pairs (class mismatch under
    cfg.class_aware) are gated infeasible like a failed IoU gate.
    `track_boxes_alt` is an optional second box hypothesis per track
    (cfg.assoc_box="best": the Kalman prediction alongside the
    KCF-refined box) — each pair scores the BETTER of the two IoUs, so
    an appearance lock onto the wrong target cannot veto a perfectly
    good motion-consistent match (the identical-texture bounce fixture,
    examples/class_aware_mot.py)."""
    iou = pairwise_iou(track_boxes, det_boxes)
    if track_boxes_alt is not None:
        iou = jnp.maximum(iou, pairwise_iou(track_boxes_alt, det_boxes))
    cost = 1.0 - iou
    if appearance is not None and appearance_weight > 0.0:
        cost = ((1.0 - appearance_weight) * cost
                + appearance_weight * (1.0 - jnp.clip(appearance, 0.0, 1.0)))
    feasible = ((iou >= iou_gate)
                & track_valid[:, None] & det_valid[None, :])
    if class_gate is not None:
        feasible = feasible & class_gate
    return jnp.where(feasible, cost, infeasible)
