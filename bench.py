"""Canonical benchmark: tracked frames/sec/chip at 128 live tracks.

Driver metric (BASELINE.json): "MOT16 tracked frames/sec/chip at 128
tracks"; north-star >= 2000 fps/chip.  MOT16 itself cannot be downloaded in
this environment (zero egress), so the load is the synthetic MOT16 stand-in
fixture at 1080p with 128 live objects and per-frame detections — the same
shapes and the full per-frame pipeline (KCF detect + train over all 128
tracks, Kalman, cost, auction, lifecycle) that MOT16 at 128 tracks
exercises.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import sys
import time

import numpy as np


def main() -> None:
    from jaxmot.utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.tracker.api import pad_detections
    from jaxmot.utils import metrics

    height, width = 1080, 1920
    n_obj = 128
    n_frames = 64
    reps = 5

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=0,
                                             frame_hw=(height, width))

    cfg = TrackerConfig(max_tracks=128, max_detections=160,
                        frame_height=height, frame_width=width)
    d = np.zeros((n_frames, cfg.max_detections, 5), np.float32)
    v = np.zeros((n_frames, cfg.max_detections), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], cfg.max_detections)

    frames_u8 = (frames * 255).astype(np.uint8)
    fj = jnp.asarray(frames_u8)
    dj = jnp.asarray(d)
    vj = jnp.asarray(v)
    bank0 = bank_mod.empty_bank(cfg)

    # Warmup / compile + correctness sanity (tracker must actually track).
    bank, out = scan.run_sequence(bank0, fj, dj, vj, cfg)
    jax.block_until_ready(out.boxes)
    hyp = []
    ids_np = np.asarray(out.ids)
    boxes_np = np.asarray(out.boxes)
    valid_np = np.asarray(out.valid)
    for f in range(n_frames):
        sel = np.where(valid_np[f])[0]
        hyp.append((ids_np[f, sel], boxes_np[f, sel]))
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]
    mota = metrics.clear_mot(gt, hyp)["mota"]
    h_all = metrics.hota(gt, hyp)
    hota = h_all["hota"]

    # Timed: device-resident sequence tracking (frames already in device
    # memory, as in the serving pipeline where decode feeds the device).
    # Reps form a DEPENDENT chain (the bank carries forward) ending in a
    # forced small device→host fetch; the reported number is the marginal
    # cost per chunk — chain(reps) minus chain(1) over (reps-1) — which
    # cancels the fixed per-call dispatch and fetch cost.
    def chain(n):
        b = bank
        t0 = time.perf_counter()
        for _ in range(n):
            b, o = scan.run_sequence(b, fj, dj, vj, cfg)
        float(np.asarray(o.n_alive).sum())          # forced fetch
        return time.perf_counter() - t0

    chain(1)                                        # warm
    t1 = min(chain(1) for _ in range(2))
    tns = [chain(reps + 1) for _ in range(2)]
    tn = min(tns)
    dt = (tn - t1) / reps
    # If a slow window distorted the short chain past the long one, dt
    # can go non-positive — report 0 (a valid, finite JSON number).
    fps = n_frames / dt if dt > 1e-9 else 0.0
    # Spread from the two long-chain samples.
    fps_all = sorted(n_frames * reps / (t - t1) for t in tns
                     if (t - t1) > 1e-9)
    spread = ([round(fps_all[0], 1), round(fps_all[-1], 1)]
              if fps_all else [0.0, 0.0])

    # Report degraded number if the tracker is not actually tracking.
    if mota < 0.5:
        fps = 0.0

    print(json.dumps({
        "metric": "synthetic-MOT16-1080p tracked frames/sec/chip @128 tracks",
        "value": round(fps, 1),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 2000.0, 3),
        "extra": {"mota_sanity": round(float(mota), 4),
                  "hota": round(float(hota), 4),
                  "deta": round(float(h_all["deta"]), 4),
                  "assa": round(float(h_all["assa"]), 4),
                  "loca": round(float(h_all["loca"]), 4),
                  "spread_fps": spread,
                  "n_frames": n_frames,
                  "device": {"platform": jax.devices()[0].platform,
                             "kind": jax.devices()[0].device_kind,
                             "count": len(jax.devices())}},
    }))


if __name__ == "__main__":
    sys.exit(main())
