"""Whole-ingest-path demonstration on the accelerator:
threaded decoders → native StreamScheduler ring → device feeder →
multi-stream tracking step, sustained — frames flow through the ring, not
pre-staged device arrays.

Reports steps/s, aggregate tracked fps, and the scheduler's drop /
repeat / fresh counters.  Each feeder step pays one host->device copy of
the gathered batch and one dispatch (tools/bench_latency.py decomposes
those costs).

Run:  python tools/bench_ingest.py
Prints ONE JSON line.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.native import StreamScheduler
    from jaxmot.parallel import serve
    from jaxmot.tracker.api import pad_detections

    height, width = 1080, 1920
    n_streams = 4
    n_frames = 40          # per stream
    max_dets = 64

    # Independent synthetic 1080p scenes (pre-rendered on host — the
    # "decoder" threads then stream them through the ring in real time).
    scenes = []
    for sid in range(n_streams):
        rng = np.random.default_rng(sid)
        objs = synthetic.make_objects(32, height, width, rng,
                                      min_size=24, max_size=64,
                                      max_speed=3.0)
        frames, boxes, vis = synthetic.render_sequence(
            objs, n_frames, height, width, seed=sid, noise=0.01)
        dets = synthetic.detections_from_gt(boxes, vis, seed=sid,
                                            frame_hw=(height, width))
        scenes.append(((frames * 255).astype(np.uint8), dets))

    cfg = TrackerConfig(max_tracks=128, max_detections=max_dets,
                        frame_height=height, frame_width=width)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("stream",))
    sh = NamedSharding(mesh, P("stream"))
    banks = serve.make_stream_banks(n_streams, cfg, mesh)

    sched = StreamScheduler(n_streams, frame_shape=(height, width),
                            capacity=4, dtype=np.uint8)

    stop = threading.Event()

    def decoder(sid):
        # Push at ~60 fps per stream so the ring's drop and repeat
        # policies are exercised.
        for f in range(n_frames):
            if stop.is_set():
                return
            sched.push(sid, scenes[sid][0][f])
            time.sleep(1 / 60)

    threads = [threading.Thread(target=decoder, args=(s,), daemon=True)
               for s in range(n_streams)]

    # Precompute padded per-frame detections per stream; the feeder pairs
    # each gathered batch with the newest available detections (frame
    # alignment via the ring's repeat policy is the demo's point, not
    # detector latency).
    det_pad = np.zeros((n_streams, n_frames, max_dets, 5), np.float32)
    det_val = np.zeros((n_streams, n_frames, max_dets), bool)
    for s in range(n_streams):
        for f in range(n_frames):
            det_pad[s, f], det_val[s, f] = pad_detections(
                scenes[s][1][f], max_dets)

    # Warm compile before starting the clock (not part of serving).
    f0 = jax.device_put(jnp.asarray(np.stack(
        [scenes[s][0][0] for s in range(n_streams)])), sh)
    d0 = jax.device_put(jnp.asarray(det_pad[:, 0]), sh)
    v0 = jax.device_put(jnp.asarray(det_val[:, 0]), sh)
    banks, out = serve.multi_stream_step(banks, f0, d0, v0, cfg)
    jax.block_until_ready(out.boxes)

    for t in threads:
        t.start()
    steps = 0
    fed_frames = 0
    t0 = time.perf_counter()
    deadline = t0 + 20.0
    fidx = np.zeros(n_streams, np.int64)
    while time.perf_counter() < deadline:
        got = sched.gather()
        if got is None:
            time.sleep(0.002)
            continue
        batch, fresh = got
        d = np.stack([det_pad[s, min(fidx[s], n_frames - 1)]
                      for s in range(n_streams)])
        v = np.stack([det_val[s, min(fidx[s], n_frames - 1)]
                      for s in range(n_streams)])
        fidx += np.asarray(fresh, np.int64)
        banks, out = serve.multi_stream_step(
            banks, jax.device_put(jnp.asarray(batch), sh),
            jax.device_put(jnp.asarray(d), sh),
            jax.device_put(jnp.asarray(v), sh), cfg)
        steps += 1
        fed_frames += int(np.sum(fresh))
        if all(fidx >= n_frames):
            break
    jax.block_until_ready(out.boxes)
    wall = time.perf_counter() - t0
    stop.set()
    for t in threads:
        t.join(timeout=2)

    stats = sched.stats()
    alive = np.asarray(out.n_alive).tolist()
    print(json.dumps({
        "metric": "scheduler-fed 1080p multi-stream serving",
        "value": round(steps / wall, 2),
        "unit": "steps/sec",
        "extra": {
            "streams": n_streams,
            "steps": steps,
            "fresh_frames_tracked": fed_frames,
            "aggregate_tracked_fps": round(n_streams * steps / wall, 1),
            "sched_stats": {k: (np.asarray(v).tolist()
                                if hasattr(v, "__len__") else v)
                            for k, v in stats.items()},
            "alive_per_stream_at_end": alive,
            "note": "per-step wall includes one H2D copy and dispatch",
            "device": str(jax.devices()[0]),
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
