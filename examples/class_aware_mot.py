"""Class-aware MOT demo — the 6-column detection form end to end.

Two VISUALLY IDENTICAL targets of different detector classes approach
head-on and elastically bounce off each other: constant-velocity
prediction continues PAST the bounce, so IoU pairs each track with the
other object, and KCF appearance refinement cannot help because the
pixels match (the r3 appearance sweep measured IDF1 0.51 on exactly this
fixture).  The detector class id — a 6th detection column — is the one
signal that disambiguates; cfg.class_aware gates the cross-class match
infeasible and identity survives.  Scored with CLEAR-MOT and HOTA side
by side, class gate on vs off.

Runs anywhere (CPU or GPU):
    python examples/class_aware_mot.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax.numpy as jnp

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.utils import metrics

    h, w, n_frames = 240, 320, 40
    speed, meet, y = 4.0, 160.0, 120.0
    f_meet = n_frames // 2
    t = np.arange(n_frames)
    cx1 = np.where(t <= f_meet, meet - speed * (f_meet - t),
                   meet - speed * (t - f_meet))    # approach then bounce
    centers = np.zeros((n_frames, 2, 2))
    centers[:, 0] = np.stack([cx1, np.full(n_frames, y - 1.0)], -1)
    centers[:, 1] = np.stack([2 * meet - cx1,
                              np.full(n_frames, y + 1.0)], -1)
    sizes = np.asarray([[20.0, 20.0], [20.0, 20.0]])
    classes = np.asarray([0, 1], np.int64)
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, h, w, seed=42, tex_levels=[0.45, 0.45])
    # Simulated detector output WITH the class column ([D, 6]); a real
    # detector produces the same form via models.detector
    # detect_batch(...) + dets_with_classes(dets, classes).
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=1, jitter=1.0, frame_hw=(h, w), classes=classes)

    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    # Three operating points: class-blind; class gate alone (the gate
    # blocks the swap but the KCF template has locked onto the
    # look-alike, so the track coasts as a phantom — fragmentation);
    # gate + assoc_box="best" (the Kalman hypothesis rides along, the
    # same-class detection re-matches, identity survives).
    for aware, abox in ((False, "refined"), (True, "refined"),
                        (True, "best")):
        cfg = TrackerConfig(max_tracks=16, max_detections=16,
                            frame_height=h, frame_width=w, n_init=2,
                            class_aware=aware,
                            assoc_box=abox)
        d = np.zeros((n_frames, 16, 6), np.float32)
        v = np.zeros((n_frames, 16), bool)
        from jaxmot.tracker.api import pad_detections
        for f in range(n_frames):
            d[f], v[f] = pad_detections(dets_list[f], 16)
        dj = jnp.asarray(d if aware else d[..., :5])
        _, outs = scan.run_sequence(bank_mod.empty_bank(cfg),
                                    jnp.asarray(frames), dj,
                                    jnp.asarray(v), cfg)
        hyp = []
        ids, bxs, val = (np.asarray(outs.ids), np.asarray(outs.boxes),
                         np.asarray(outs.valid))
        for f in range(n_frames):
            sel = np.where(val[f])[0]
            hyp.append((ids[f, sel], bxs[f, sel]))
        m = metrics.clear_mot(gt, hyp)
        ho = metrics.hota(gt, hyp)
        print(f"class_aware={aware!s:5} assoc_box={abox:9}"
              f"  MOTA {m['mota']:.3f}  "
              f"IDF1 {m['idf1']:.3f}  HOTA {ho['hota']:.3f}  "
              f"(DetA {ho['deta']:.3f} / AssA {ho['assa']:.3f})  "
              f"IDSW {m['idsw']}")


if __name__ == "__main__":
    main()
