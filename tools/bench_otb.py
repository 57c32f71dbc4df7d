"""Single-object OTB-flow bench (BASELINE configs[1] shape): whole-clip
`kcf_bank.run_otb_sequence` on 480x640 frames, gray and fHOG+3-scale,
refined- vs detect-site retraining (train_site, r3b).

Dependent-chain marginal methodology (bench.py docstring).  Prints one
JSON line per (feature mode, train_site).
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

    from jaxmot.config import KCFConfig
    from jaxmot.data import synthetic
    from jaxmot.ops import patch as patch_ops
    from jaxmot.tracker import kcf_bank

    # reps must be LARGE here: a T=1 whole-clip program runs a few ms, so
    # a 5-rep marginal chain is inside the host's timing jitter.
    n_frames, reps = 64, 64
    objs = [synthetic.SyntheticObject(cx=320, cy=240, w=36, h=30,
                                      vx=2.0, vy=-1.2)]
    frames, boxes, _ = synthetic.render_sequence(objs, n_frames, 480, 640,
                                                 seed=3, noise=0.005)
    fj = jnp.asarray(frames)

    variants = [
        ("gray", KCFConfig()),
        ("fhog", KCFConfig(feature_type="hog", cell_size=4)),
        ("fhog-3scale", KCFConfig(feature_type="hog", cell_size=4,
                                  scale_step=1.05)),
    ]
    for name, cfg in variants:
        gray0 = patch_ops.to_gray(fj[0])
        bank0 = kcf_bank.init_bank(gray0, jnp.asarray(boxes[0, :1]),
                                   jnp.ones((1,), bool), cfg)
        for site in ("refined", "detect"):
            bank, got, _ = kcf_bank.run_otb_sequence(bank0, fj[1:], cfg,
                                                     train_site=site)
            jax.block_until_ready(got)
            err = np.hypot(
                np.asarray(got[:, 0, 0]) - boxes[1:, 0, 0],
                np.asarray(got[:, 0, 1]) - boxes[1:, 0, 1])

            def chain(n, _bank=bank, _cfg=cfg, _site=site):
                b = _bank
                t0 = time.perf_counter()
                for _ in range(n):
                    b, bx, _pk = kcf_bank.run_otb_sequence(
                        b, fj[1:], _cfg, train_site=_site)
                float(np.asarray(bx[-1, 0, 0]))
                return time.perf_counter() - t0

            chain(1)
            t1 = min(chain(1) for _ in range(3))
            tn = min(chain(reps + 1) for _ in range(3))
            dt = (tn - t1) / reps
            fps = (n_frames - 1) / dt if dt > 1e-9 else 0.0
            print(json.dumps({
                "config": name, "train_site": site,
                "fps": round(fps, 1),
                "max_center_err_px": round(float(err.max()), 3),
                # OTB's published criterion is precision@20px — flag rows
                # where the tracker left that envelope rather than let a
                # lost track "win" a speed row.  Known: fHOG drifts off
                # this 63-frame KCF-only synthetic fixture in BOTH train
                # sites (slow EMA drift at 4-px cell resolution, 3.9 px
                # by frame 39 on CPU) — in the MOT pipeline detections
                # re-anchor it every frame (MOTA 0.969, bench_variants).
                "tracking_ok": bool(err.max() < 20.0),
            }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
