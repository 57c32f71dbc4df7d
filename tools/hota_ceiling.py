"""Bench-fixture HOTA ceiling + attribution.

bench.py scores the tracker on a fixture whose detections are jittered
GT (sigma 1 px center, 2% size, no drops/FPs) and whose births
initialize one frame late by design.  This measures the fixture's own
ceiling, so the gap between it and bench.py's HOTA reads as tracker
error rather than fixture noise.

Tiers, all through the SAME metrics.hota scorer as bench.py:
  gt_fed        GT boxes + GT ids            → scorer sanity (must be 1.0)
  oracle_assoc  bench detections + GT ids    → fixture ceiling: what a
                perfect associator scores given the detection jitter
  oracle_late   + first visible frame of each object dropped → adds the
                tracker's designed one-frame-late birth
  (tracker)     bench.py's HOTA, passed as --tracker-hota, for the gap
                statement

Pure metric-layer numpy; runs on CPU:
    python tools/hota_ceiling.py [--tracker-hota H]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracker-hota", type=float, default=None,
                    help="bench.py's HOTA on the same fixture")
    args = ap.parse_args()
    from jaxmot.data import synthetic
    from jaxmot.utils import metrics

    # Exactly bench.py's fixture construction (seeds, shapes, knobs).
    height, width = 1080, 1920
    n_obj, n_frames = 128, 64
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    del frames
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=0,
                                             frame_hw=(height, width))

    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    def score(hyp, name):
        h = metrics.hota(gt, hyp)
        mota = metrics.clear_mot(gt, hyp)["mota"]
        print(json.dumps({"tier": name,
                          "hota": round(float(h["hota"]), 4),
                          "deta": round(float(h["deta"]), 4),
                          "assa": round(float(h["assa"]), 4),
                          "loca": round(float(h["loca"]), 4),
                          "mota": round(float(mota), 4)}), flush=True)
        return h

    # Tier 0: scorer sanity.
    score([(ids, b.copy()) for ids, b in gt], "gt_fed")

    # Tier 1: oracle association on the bench detections. With
    # drop_prob=0 / fp=0 the det rows are emitted in visible-object
    # order, so det j of frame f IS object np.where(vis[f])[0][j].
    oracle = []
    for f in range(n_frames):
        ids = np.where(vis[f])[0]
        assert len(ids) == len(dets_list[f])
        oracle.append((ids, dets_list[f][:, :4].copy()))
    ceil = score(oracle, "oracle_assoc")

    # Tier 2: + one-frame-late births (the tracker's designed lifecycle:
    # a detection must exist before a track does, so each object's first
    # visible frame has no emitted box).
    first_seen = np.full(n_obj, -1, np.int64)
    for f in range(n_frames):
        new = (vis[f]) & (first_seen < 0)
        first_seen[new] = f
    late = []
    for f in range(n_frames):
        ids = np.where(vis[f])[0]
        keep = first_seen[ids] < f
        late.append((ids[keep], dets_list[f][:, :4][keep].copy()))
    late_h = score(late, "oracle_late_birth")

    attribution = {
        "tier": "attribution",
        "fixture_ceiling_hota": round(float(ceil["hota"]), 4),
        "late_birth_cost": round(float(ceil["hota"] - late_h["hota"]), 4)}
    if args.tracker_hota is not None:
        attribution["tracker_gap_vs_late_ceiling"] = round(
            float(late_h["hota"]) - args.tracker_hota, 4)
    print(json.dumps(attribution), flush=True)


if __name__ == "__main__":
    main()
