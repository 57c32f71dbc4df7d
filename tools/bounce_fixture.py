"""Identical-texture bounce fixture — the KCF precision canary.

Two identically textured objects approach, meet and bounce apart.  Only
the KCF appearance model tells them apart through the crossing, and that
model is trained by a spectral divide (ops/kcf.train) that amplifies
rounding in the forward feature spectra.  A CPU run computes every dot
in float32, so only a run on the accelerator separates the
kcf_precision modes: a mode whose forward DFT dots round too coarsely
swaps the two identities at the crossing and IDF1 falls well below 1.

Geometry mirrors tests/test_class_aware.py::
test_bounce_gate_and_best_assoc_matrix; the config is the shipped
default (class_aware, assoc_box auto -> best) with kcf_precision set per
mode.

Usage: python tools/bounce_fixture.py [mode ...]
  (modes: auto default fwd_high high highest — each a kcf_precision
  value; default: auto).  Prints one JSON line per mode; exits nonzero
  if the shipped mode ("auto") scores IDF1 below MIN_IDF1.
"""

import json
import os
import sys

import numpy as np

MIN_IDF1 = 0.95
MODES = ("default", "fwd_high", "high", "highest")


def run_bounce(modes=("auto",)) -> dict:
    """Track the fixture once per kcf_precision mode; returns
    {mode: {"resolved", "idf1", "idsw", "fp", "fn"}}."""
    import jax.numpy as jnp

    from jaxmot.config import KCFConfig, TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod, scan
    from jaxmot.tracker.api import pad_detections
    from jaxmot.utils import metrics

    h, w, n_frames, speed = 240, 320, 40, 4.0
    meet, y = 160.0, 120.0
    f_meet = n_frames // 2
    t = np.arange(n_frames)
    cx1 = np.where(t <= f_meet, meet - speed * (f_meet - t),
                   meet - speed * (t - f_meet))
    centers = np.zeros((n_frames, 2, 2))
    centers[:, 0] = np.stack([cx1, np.full(n_frames, y - 1.0)], -1)
    centers[:, 1] = np.stack([2 * meet - cx1,
                              np.full(n_frames, y + 1.0)], -1)
    sizes = np.asarray([[20.0, 20.0], [20.0, 20.0]])
    classes = np.asarray([0, 1], np.int64)
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, h, w, seed=42, tex_levels=[0.45, 0.45])
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=1, jitter=1.0, frame_hw=(h, w), classes=classes)

    d = np.zeros((n_frames, 16, 6), np.float32)
    v = np.zeros((n_frames, 16), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], 16)
    gt = [(np.where(vis[f])[0], boxes[f, vis[f]]) for f in range(n_frames)]

    results = {}
    for mode in modes:
        cfg = TrackerConfig(max_tracks=16, max_detections=16,
                            frame_height=h, frame_width=w, n_init=2,
                            class_aware=True, kcf_precision=mode,
                            kcf=KCFConfig())
        _, outs = scan.run_sequence(bank_mod.empty_bank(cfg),
                                    jnp.asarray(frames), jnp.asarray(d),
                                    jnp.asarray(v), cfg)
        ids = np.asarray(outs.ids)
        bxs = np.asarray(outs.boxes)
        val = np.asarray(outs.valid)
        hyp = [(ids[f, val[f]], bxs[f, val[f]]) for f in range(n_frames)]
        m = metrics.clear_mot(gt, hyp)
        results[mode] = {"resolved": cfg.kcf_precision_resolved,
                         "idf1": float(m["idf1"]), "idsw": int(m["idsw"]),
                         "fp": int(m["fp"]), "fn": int(m["fn"])}
    return results


def main() -> int:
    import jax

    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    modes = sys.argv[1:] or ["auto"]
    rc = 0
    for mode, r in run_bounce(modes).items():
        print(json.dumps({"mode": mode, **r}), flush=True)
        if mode == "auto" and r["idf1"] < MIN_IDF1:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
