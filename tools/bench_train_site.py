"""A/B bench: cfg.train_site "refined" (second ROI extraction at the
corrected boxes) vs "detect" (Fourier-aligned reuse of the detect-site
spectra, ops/kcf.shift_spectrum) on the canonical 1080p@128 fixture and
the reference-faithful heavy config (fHOG-31 + 3-scale).

Same dependent-chain marginal methodology as bench.py; each row reports
fps AND MOTA sanity so a fast-but-broken mode cannot win.

Run:  python tools/bench_train_site.py
Prints one JSON line per (config, mode).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp

    from jaxmot.config import KCFConfig, TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.tracker.api import pad_detections
    from jaxmot.utils import metrics

    height, width = 1080, 1920
    n_obj, n_frames, reps = 128, 64, 5

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=0,
                                             frame_hw=(height, width))
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    fj = jnp.asarray((frames * 255).astype(np.uint8))

    variants = [
        ("default-gray", dict()),
        ("fhog-3scale", dict(kcf=KCFConfig(feature_type="hog", cell_size=4,
                                           scale_step=1.05))),
    ]

    for name, kcf_kw in variants:
        for site in ("refined", "detect"):
            cfg = TrackerConfig(max_tracks=128, max_detections=160,
                                frame_height=height, frame_width=width,
                                train_site=site, **kcf_kw)
            d = np.zeros((n_frames, cfg.max_detections, 5), np.float32)
            v = np.zeros((n_frames, cfg.max_detections), bool)
            for f in range(n_frames):
                d[f], v[f] = pad_detections(dets_list[f],
                                            cfg.max_detections)
            dj, vj = jnp.asarray(d), jnp.asarray(v)
            bank0 = bank_mod.empty_bank(cfg)

            bank, out = scan.run_sequence(bank0, fj, dj, vj, cfg)
            jax.block_until_ready(out.boxes)
            ids_np, boxes_np, valid_np = (np.asarray(out.ids),
                                          np.asarray(out.boxes),
                                          np.asarray(out.valid))
            hyp = [(ids_np[f, valid_np[f]], boxes_np[f, valid_np[f]])
                   for f in range(n_frames)]
            m = metrics.clear_mot(gt, hyp)

            def chain(n, _bank=bank, _cfg=cfg, _dj=dj, _vj=vj):
                b = _bank
                t0 = time.perf_counter()
                for _ in range(n):
                    b, o = scan.run_sequence(b, fj, _dj, _vj, _cfg)
                float(np.asarray(o.n_alive).sum())
                return time.perf_counter() - t0

            chain(1)
            t1 = min(chain(1) for _ in range(2))
            tn = min(chain(reps + 1) for _ in range(2))
            dt = (tn - t1) / reps
            fps = n_frames / dt if dt > 1e-9 else 0.0
            print(json.dumps({
                "config": name, "train_site": site,
                "fps": round(fps, 1),
                "mota_sanity": round(float(m["mota"]), 4),
                "idf1": round(float(m["idf1"]), 4),
                "idsw": int(m["idsw"]),
            }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
