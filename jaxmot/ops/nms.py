"""On-device non-maximum suppression with static shapes.

Reference: NMS inside the TF YOLO wrapper's postprocess (SURVEY.md §2 row
"detector (YOLO)").  Static-shape form: fixed-capacity greedy NMS as a
lax.fori_loop over output slots — each iteration selects the best remaining
box and suppresses its IoU neighborhood; no dynamic shapes anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jaxmot.ops.iou import pairwise_iou


def nms(boxes: jnp.ndarray, scores: jnp.ndarray, max_out: int,
        iou_thr: float = 0.45, score_thr: float = 0.0,
        pre_top_k: int | None = None):
    """Greedy NMS.

    boxes  : [N, 4] (cx, cy, w, h)
    scores : [N] (0 = invalid/padding)
    Returns (indices [max_out] int32 with -1 padding, valid [max_out] bool).

    Candidates are pre-filtered to the top `pre_top_k` scores (default
    8*max_out, capped at N) before the [K, K] IoU precompute: the raw YOLO
    head emits N=2535 anchors at 416 px, and a full [N, N] IoU is 26 MB of
    HBM traffic per frame (822 MB for a 32-frame batch) — the standard
    top-K prefilter (TF combined_non_max_suppression and torchvision
    batched NMS do the same) bounds it at [512, 512].

    Exactness contract: the result equals unfiltered greedy NMS unless
    greedy suppresses more than K - max_out of the top-K candidates —
    i.e. a pathologically crowded same-class scene where > 7*max_out of
    the highest-scored boxes collapse onto < max_out keeps AND real
    detections rank below K.  Pass pre_top_k >= N to disable the filter
    and make the loop exact unconditionally.
    """
    n = boxes.shape[0]
    k = min(n, pre_top_k if pre_top_k is not None else 8 * max_out)
    if k < n:
        top_scores, top_idx = jax.lax.top_k(scores, k)
        boxes = boxes[top_idx]
        scores = top_scores
    else:
        top_idx = None
    iou = pairwise_iou(boxes, boxes)                    # [K, K]
    live = scores > score_thr

    def body(_, state):
        live, out_idx, out_valid, k = state
        s = jnp.where(live, scores, -1.0)
        best = jnp.argmax(s).astype(jnp.int32)
        ok = s[best] > score_thr
        # Suppress the winner's neighborhood (including itself).
        suppress = iou[best] >= iou_thr
        live = live & ~(suppress & ok)
        live = live.at[best].set(False)
        out_idx = out_idx.at[k].set(jnp.where(ok, best, -1))
        out_valid = out_valid.at[k].set(ok)
        return live, out_idx, out_valid, k + 1

    init = (live, jnp.full((max_out,), -1, jnp.int32),
            jnp.zeros((max_out,), bool), jnp.int32(0))
    _, out_idx, out_valid, _ = jax.lax.fori_loop(0, max_out, body, init)
    if top_idx is not None:
        # Map filtered indices back to the caller's box numbering.
        out_idx = jnp.where(out_valid,
                            top_idx[jnp.clip(out_idx, 0, k - 1)], -1)
    return out_idx, out_valid


def fast_nms(boxes: jnp.ndarray, scores: jnp.ndarray, max_out: int,
             iou_thr: float = 0.45, score_thr: float = 0.0,
             pre_top_k: int | None = None):
    """Parallel NMS (the YOLACT "Fast NMS" relaxation): one triangular
    IoU-mask reduction instead of max_out sequential argmax/suppress
    steps, which run one after another.

    Relaxation: a box is suppressed if ANY higher-scored box overlaps it
    above the threshold, whether or not that box itself survived.  The
    kept set is therefore mutually non-overlapping at iou_thr (same
    guarantee as greedy) but can be a strict subset of greedy's — YOLACT
    reports ~0.1 mAP cost; tests/test_detector.py asserts the invariants.

    Same interface/returns as nms().
    """
    n = boxes.shape[0]
    k = min(n, pre_top_k if pre_top_k is not None else 8 * max_out)
    top_scores, top_idx = jax.lax.top_k(scores, k)      # score-descending
    b = boxes[top_idx]
    iou = pairwise_iou(b, b)                            # [K, K]
    higher = jax.lax.broadcasted_iota(jnp.int32, (k, k), 1) \
        < jax.lax.broadcasted_iota(jnp.int32, (k, k), 0)   # j < i
    sup = jnp.max(jnp.where(higher, iou, 0.0), axis=1)  # [K]
    keep = (sup < iou_thr) & (top_scores > score_thr)
    # Kept boxes are already in score order: pack them into the static
    # output by rank.
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    slot = jnp.where(keep & (rank < max_out), rank, max_out)
    out_idx = jnp.full((max_out,), -1, jnp.int32).at[slot].set(
        top_idx.astype(jnp.int32), mode="drop")
    valid = jnp.zeros((max_out,), bool).at[slot].set(True, mode="drop")
    return out_idx, valid


def nms_classwise(boxes: jnp.ndarray, scores: jnp.ndarray,
                  classes: jnp.ndarray, max_out: int,
                  iou_thr: float = 0.45, score_thr: float = 0.0,
                  impl: str = "greedy",
                  pre_top_k: int | None = None):
    """Class-aware NMS: boxes of different classes never suppress each
    other (the standard YOLO postprocess).  Implemented by offsetting box
    centers per class so cross-class IoU is zero.

    impl: "greedy" (sequential; exact up to the top-K prefilter contract
    documented on nms()) or "fast" (parallel relaxation).
    pre_top_k: forwarded to the implementation; pass >= N for
    unconditionally exact greedy."""
    offset = classes.astype(jnp.float32) * 1e5
    shifted = boxes.at[:, 0].add(offset)
    fn = fast_nms if impl == "fast" else nms
    return fn(shifted, scores, max_out, iou_thr, score_thr,
              pre_top_k=pre_top_k)
