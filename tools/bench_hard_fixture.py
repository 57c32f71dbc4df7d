"""Hard-fixture accuracy benchmark: detector dropouts + false positives
+ heavy jitter at the bench scale (1080p, 128 objects).

Motivation (tools/hota_ceiling.py): the canonical bench fixture is
SATURATED — the tracker's HOTA sits above the late-birth oracle
ceiling, so the bench cannot measure accuracy work.  This
fixture injects the failure modes the KCF+SORT fusion exists for
(SURVEY §5 fault-injection hook): 25% per-detection dropout, ~4 false
positives/frame, 2 px center jitter.  Tiers:

  oracle      per-frame IoU>=0.5 Hungarian match of the noisy dets onto
              GT, hyp ids = matched GT ids, FPs discarded — what a
              perfect associator + perfect FP filter scores given the
              detections (the realizable ceiling WITHOUT coasting)
  sort-only   cfg.use_kcf=False: IoU+Kalman+auction, no KCF refinement
              or coasting signal (the classic SORT baseline)
  shipped     full defaults (KCF detect+train, psr gate, detect-site
              training) — the pipeline's value-add under stress
  shipped+tsu output_max_tsu=1: emit only tracks matched this frame
              (the noisy-detector operating point train_e2e_mota found)

Run:  python tools/bench_hard_fixture.py  (JAXMOT_HARD_SMALL=1 for
smoke shapes on the CPU); one JSON line per tier.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _oracle(gt, dets_list, iou_thr=0.5):
    """Per-frame optimal IoU matching of detections onto GT (scipy
    Hungarian on the host — the ceiling estimator, not the pipeline)."""
    from scipy.optimize import linear_sum_assignment

    def iou_mat(a, b):
        ax1 = a[:, 0] - a[:, 2] / 2; ay1 = a[:, 1] - a[:, 3] / 2
        ax2 = a[:, 0] + a[:, 2] / 2; ay2 = a[:, 1] + a[:, 3] / 2
        bx1 = b[:, 0] - b[:, 2] / 2; by1 = b[:, 1] - b[:, 3] / 2
        bx2 = b[:, 0] + b[:, 2] / 2; by2 = b[:, 1] + b[:, 3] / 2
        iw = np.maximum(0, np.minimum(ax2[:, None], bx2[None]) -
                        np.maximum(ax1[:, None], bx1[None]))
        ih = np.maximum(0, np.minimum(ay2[:, None], by2[None]) -
                        np.maximum(ay1[:, None], by1[None]))
        inter = iw * ih
        union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] \
            - inter
        return inter / np.maximum(union, 1e-9)

    hyp = []
    for (gids, gboxes), dets in zip(gt, dets_list):
        d = dets[:, :4]
        if len(gids) == 0 or len(d) == 0:
            hyp.append((np.zeros(0, np.int64), np.zeros((0, 4))))
            continue
        m = iou_mat(d, gboxes)
        ri, ci = linear_sum_assignment(-m)
        keep = m[ri, ci] >= iou_thr
        hyp.append((gids[ci[keep]], d[ri[keep]]))
    return hyp


def main() -> None:
    import jax
    import jax.numpy as jnp

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.tracker.api import pad_detections
    from jaxmot.utils import metrics

    small = os.environ.get("JAXMOT_HARD_SMALL", "0") == "1"
    height, width = (240, 320) if small else (1080, 1920)
    n_obj = 16 if small else 128
    n_frames = 24 if small else 64
    max_dets = n_obj + 40

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=0, jitter=2.0, drop_prob=0.25, fp_per_frame=4.0,
        frame_hw=(height, width))
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    def score(hyp, tier, extra=None):
        h = metrics.hota(gt, hyp)
        cm = metrics.clear_mot(gt, hyp)
        row = {"tier": tier, "hota": round(float(h["hota"]), 4),
               "deta": round(float(h["deta"]), 4),
               "assa": round(float(h["assa"]), 4),
               "loca": round(float(h["loca"]), 4),
               "mota": round(float(cm["mota"]), 4),
               "idf1": round(float(cm["idf1"]), 4),
               "idsw": int(cm["idsw"])}
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)

    score(_oracle(gt, dets_list), "oracle (IoU-match, FPs discarded)")

    frames_u8 = jnp.asarray((frames * 255).astype(np.uint8))
    d = np.zeros((n_frames, max_dets, 5), np.float32)
    v = np.zeros((n_frames, max_dets), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], max_dets)
    dj, vj = jnp.asarray(d), jnp.asarray(v)

    def run(tier, **cfg_kw):
        cfg = TrackerConfig(max_tracks=max(2 * n_obj, 64),
                            max_detections=max_dets,
                            frame_height=height, frame_width=width,
                            **cfg_kw)
        bank, out = scan.run_sequence(bank_mod.empty_bank(cfg), frames_u8,
                                      dj, vj, cfg)
        jax.block_until_ready(out.boxes)
        ids_np = np.asarray(out.ids)
        boxes_np = np.asarray(out.boxes)
        valid_np = np.asarray(out.valid)
        hyp = []
        for f in range(n_frames):
            sel = np.where(valid_np[f])[0]
            hyp.append((ids_np[f, sel], boxes_np[f, sel]))
        score(hyp, tier, {"cfg": cfg_kw and str(cfg_kw) or "defaults"})

    run("sort-only (use_kcf=False)", use_kcf=False)
    run("shipped defaults")
    run("shipped + output_max_tsu=1", output_max_tsu=1)

    if "--sweep" in sys.argv:
        # Lifecycle operating points under dropout+FP stress: n_init
        # trades birth delay (DetA under 25% dropout) against FP-track
        # suppression (4 FP/frame); max_age_tentative bounds how long a
        # possibly-FP tentative track may coast.
        for n_init in (1, 2, 3):
            for mat in (1, 2):
                run(f"sweep n_init={n_init} max_age_tentative={mat}",
                    n_init=n_init, max_age_tentative=mat)


if __name__ == "__main__":
    main()
