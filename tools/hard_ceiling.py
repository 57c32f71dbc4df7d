"""Hard-fixture HOTA ceiling + attribution (r5d follow-on to
tools/hota_ceiling.py, which settled the CANONICAL fixture: saturated).

bench_hard_fixture reports shipped HOTA 0.8738 on the stress fixture
(25% dropout, ~4 FP/frame, 2 px jitter @1080p/128 obj), but the only
ceiling measured there is the NO-COASTING oracle (0.646), which the
tracker already beats by +0.23.  What a streaming tracker can actually
achieve is bounded by coasting-aware oracles.  Tiers, all host-side
numpy through the same metrics.hota scorer:

  oracle_match         per-frame IoU>=0.5 Hungarian match, FPs
                       discarded, no coasting (bench_hard_fixture's
                       tier — the detections' own content)
  coast_hold_n1        birth at an object's FIRST matched detection;
                       matched frames emit the det box, gap frames
                       re-emit the LAST det box (zero-motion coast);
                       perfect FP filter.  The realizable ceiling for a
                       hold-last-box streaming tracker.
  coast_gt_n1          same lifecycle, but gap frames emit the GT box —
                       a motion-PERFECT coaster (KF/KCF can at best
                       approach this between detections).
  coast_gt_n2          + births at the SECOND matched detection
                       (the shipped n_init=2 lifecycle), still
                       motion-perfect coasting: the ceiling for the
                       shipped lifecycle under a perfect FP filter.

Gap attribution: (coast_gt_n1 - coast_gt_n2) = the n_init=2 birth
delay cost under 25% dropout; (coast_gt_n2 - shipped 0.8738) = what
imperfect motion/FP handling actually costs; (coast_gt_n1 -
coast_hold_n1) = the value of motion-aware coasting over box-holding.

Pure metric-layer numpy; runs on CPU.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou_mat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax1 = a[:, 0] - a[:, 2] / 2; ay1 = a[:, 1] - a[:, 3] / 2
    ax2 = a[:, 0] + a[:, 2] / 2; ay2 = a[:, 1] + a[:, 3] / 2
    bx1 = b[:, 0] - b[:, 2] / 2; by1 = b[:, 1] - b[:, 3] / 2
    bx2 = b[:, 0] + b[:, 2] / 2; by2 = b[:, 1] + b[:, 3] / 2
    iw = np.maximum(0, np.minimum(ax2[:, None], bx2[None]) -
                    np.maximum(ax1[:, None], bx1[None]))
    ih = np.maximum(0, np.minimum(ay2[:, None], by2[None]) -
                    np.maximum(ay1[:, None], by1[None]))
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-9)


def main() -> None:
    from jaxmot.data import synthetic
    from jaxmot.utils import metrics

    # Exactly bench_hard_fixture.py's construction (seeds, knobs).
    height, width = 1080, 1920
    n_obj, n_frames = 128, 64
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    del frames
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=0, jitter=2.0, drop_prob=0.25, fp_per_frame=4.0,
        frame_hw=(height, width))
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    # Per-frame det -> object correspondence (IoU>=0.5 Hungarian; the
    # fixture's jitter is 2 px on >=24 px boxes so matches are unambiguous).
    matched_box = np.full((n_frames, n_obj, 4), np.nan, np.float64)
    for f in range(n_frames):
        gids, gboxes = gt[f]
        d = dets_list[f][:, :4]
        if len(gids) == 0 or len(d) == 0:
            continue
        m = _iou_mat(d, gboxes)
        ri, ci = linear_sum_assignment(-m)
        keep = m[ri, ci] >= 0.5
        matched_box[f, gids[ci[keep]]] = d[ri[keep]]

    has_det = ~np.isnan(matched_box[:, :, 0])          # [F, K]
    hit_count = np.cumsum(has_det, axis=0)             # dets seen through f

    def score(hyp, name, extra=None):
        h = metrics.hota(gt, hyp)
        cm = metrics.clear_mot(gt, hyp)
        row = {"tier": name, "hota": round(float(h["hota"]), 4),
               "deta": round(float(h["deta"]), 4),
               "assa": round(float(h["assa"]), 4),
               "loca": round(float(h["loca"]), 4),
               "mota": round(float(cm["mota"]), 4),
               "idf1": round(float(cm["idf1"]), 4)}
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)
        return h

    # Tier 0: no coasting (bench_hard_fixture's oracle, for continuity).
    hyp0 = []
    for f in range(n_frames):
        ids = np.where(has_det[f])[0]
        hyp0.append((ids, matched_box[f, ids].copy()))
    score(hyp0, "oracle_match")

    def coast_tier(n_init: int, coast: str):
        """Streaming oracle: track k live from its n_init'th matched
        detection; emits det box on hit frames, `coast` box on gaps."""
        last_box = np.full((n_obj, 4), np.nan, np.float64)
        hyp = []
        for f in range(n_frames):
            live = (hit_count[f] >= n_init) & vis[f]
            last_box[has_det[f]] = matched_box[f, has_det[f]]
            ids = np.where(live)[0]
            out = np.where(has_det[f, ids, None], matched_box[f, ids],
                           boxes[f, ids] if coast == "gt" else last_box[ids])
            hyp.append((ids, out))
        return hyp

    score(coast_tier(1, "hold"), "coast_hold_n1")
    g1 = score(coast_tier(1, "gt"), "coast_gt_n1")
    g2 = score(coast_tier(2, "gt"), "coast_gt_n2")

    shipped = 0.8738  # bench_hard_fixture.py shipped-defaults row
    print(json.dumps({
        "tier": "attribution",
        "n_init2_birth_cost": round(float(g1["hota"] - g2["hota"]), 4),
        "tracker_gap_vs_n2_ceiling": round(
            float(g2["hota"]) - shipped, 4),
        "note": "shipped = bench_hard_fixture.py defaults row"},
    ), flush=True)


if __name__ == "__main__":
    main()
