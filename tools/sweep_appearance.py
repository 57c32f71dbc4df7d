"""Does the appearance term (KCF response sampled at detection centers,
blended into the association cost) actually earn its default weight?

An earlier sweep found appearance_weight NEUTRAL on the
generic occlusion fixture, and 0.2 was shipped "for parity" with no
evidence it ever fixes an assignment.  This sweep builds scenarios where
IoU-only association DEMONSTRABLY mis-assigns — motion-reversal bounces
and dropout-masked crossings, the classic failures of motion-only cost —
with distinct textures (so the correlation response is discriminative),
plus a similar-texture control (the blend must not hurt when appearance
is uninformative).

Run on CPU:  python tools/sweep_appearance.py [--quick]
Prints one JSON line per (scenario, weight) and a VERDICT line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def _bounce_tracks(n, meet=160.0, speed=5.0, y=120.0):
    """Two objects approach head-on and elastically bounce (reverse
    velocity) when they meet: constant-velocity prediction continues
    PAST the bounce, so IoU pairs each track with the OTHER object."""
    f_meet = n // 2
    cx1 = np.where(np.arange(n) <= f_meet,
                   meet - speed * (f_meet - np.arange(n)),
                   meet - speed * (np.arange(n) - f_meet))
    cx2 = 2 * meet - cx1
    c = np.zeros((n, 2, 2), np.float64)
    c[:, 0, 0] = cx1
    c[:, 0, 1] = y - 1.0
    c[:, 1, 0] = cx2
    c[:, 1, 1] = y + 1.0
    return c


def _cross_tracks(n, meet=160.0, speed=5.0, y=120.0):
    """Two objects pass through each other; detections for BOTH are
    dropped while they overlap (NMS-merge realism) so re-acquisition
    happens with stale, ambiguous predictions."""
    cx1 = meet + speed * (np.arange(n) - n // 2)
    cx2 = 2 * meet - cx1
    c = np.zeros((n, 2, 2), np.float64)
    c[:, 0, 0] = cx1
    c[:, 0, 1] = y - 2.0
    c[:, 1, 0] = cx2
    c[:, 1, 1] = y + 2.0
    drop = np.abs(cx1 - cx2) < 30.0          # [n] overlap window
    return c, drop


def _run(scenario, aw, seed):
    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import scan
    from jaxmot.utils import metrics as metrics_mod

    n = 40
    h, w = 240, 320
    sizes = np.asarray([[28.0, 28.0], [26.0, 30.0]], np.float32)
    tex = [0.7, 0.05] if "distinct" in scenario else [0.45, 0.45]
    if scenario.startswith("bounce"):
        centers = _bounce_tracks(n)
        vis = None
        dropped = np.zeros(n, bool)
    else:
        centers, dropped = _cross_tracks(n)
        vis = None
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, h, w, seed=seed, noise=0.02, tex_levels=tex,
        visible=vis)
    det_vis = vis.copy()
    det_vis[dropped] = False
    dets = synthetic.detections_from_gt(boxes, det_vis, seed=seed,
                                        jitter=1.0, frame_hw=(h, w))
    cfg = TrackerConfig(max_tracks=8, max_detections=8,
                        frame_height=h, frame_width=w,
                        n_init=2, appearance_weight=aw)
    _, tracks, _ = scan.track_sequence(frames, dets, cfg)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n)]
    hyp = [(np.asarray([t[0] for t in tr]),
            np.asarray([t[1] for t in tr]).reshape(-1, 4))
           for tr in tracks]
    m = metrics_mod.clear_mot(gt, hyp)
    return m["mota"], m["idf1"], m["idsw"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    seeds = list(range(2)) if args.quick else list(range(8))
    weights = (0.0, 0.2, 0.5) if args.quick else \
        (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.7)
    scenarios = ("bounce_distinct", "cross_distinct", "bounce_similar",
                 "cross_similar")

    table = {}
    for sc in scenarios:
        for aw in weights:
            res = [np.asarray(_run(sc, aw, s)) for s in seeds]
            mota, idf1, idsw = np.mean(res, axis=0)
            table[(sc, aw)] = (mota, idf1, idsw)
            print(json.dumps({"scenario": sc, "appearance_weight": aw,
                              "mota": round(float(mota), 4),
                              "idf1": round(float(idf1), 4),
                              "idsw": round(float(idsw), 2)}), flush=True)

    # Decision rule: the weight must (a) maximize IDF1 summed over the
    # distinct-texture scenarios (where appearance CAN help) while (b)
    # not degrading the similar-texture controls vs w=0.
    def score(aw):
        gain = sum(table[(sc, aw)][1] for sc in scenarios if "distinct" in sc)
        harm = sum(max(0.0, table[(sc, 0.0)][1] - table[(sc, aw)][1])
                   for sc in scenarios if "similar" in sc)
        return gain - 2.0 * harm

    best = max(weights, key=score)
    print("VERDICT " + json.dumps({
        "best_weight": best,
        "idf1_distinct_at_0": round(float(np.mean(
            [table[(sc, 0.0)][1] for sc in scenarios
             if "distinct" in sc])), 4),
        "idf1_distinct_at_best": round(float(np.mean(
            [table[(sc, best)][1] for sc in scenarios
             if "distinct" in sc])), 4),
        "idsw_distinct_at_0": round(float(np.mean(
            [table[(sc, 0.0)][2] for sc in scenarios
             if "distinct" in sc])), 2),
        "idsw_distinct_at_best": round(float(np.mean(
            [table[(sc, best)][2] for sc in scenarios
             if "distinct" in sc])), 2),
    }))


if __name__ == "__main__":
    main()
