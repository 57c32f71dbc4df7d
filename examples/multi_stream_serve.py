"""Multi-stream serving demo — BASELINE configs[4] in miniature.

Eight concurrent synthetic streams tracked over a `Mesh(("stream",))`,
each device owning its stream's TrackBank; the detector stage here is the
precomputed-detection path (swap in models.detector.detect_batch for the
shared YOLO batch — see parallel.serve.detect_then_track_step).

Runs anywhere:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multi_stream_serve.py
On a host with several GPUs the same code spans its cards unchanged
(chip_smoke.py --cards 4 runs the full-size version on four).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.parallel import mesh as mesh_mod, serve
    from jaxmot.tracker.api import pad_detections
    from jaxmot.utils.profiling import FpsMeter

    n_streams = min(8, len(jax.devices()))
    n_frames = 30
    print(f"devices: {len(jax.devices())}  streams: {n_streams}")

    cfg = TrackerConfig(max_tracks=32, max_detections=16,
                        frame_height=240, frame_width=320, n_init=2)
    m = mesh_mod.stream_mesh(n_streams)
    banks = serve.make_stream_banks(n_streams, cfg, m)
    sh = NamedSharding(m, P("stream"))

    # Independent synthetic scenes per stream.
    scenes = []
    for sid in range(n_streams):
        rng = np.random.default_rng(sid)
        objs = synthetic.make_objects(8, 240, 320, rng, max_speed=2.0)
        frames, boxes, vis = synthetic.render_sequence(
            objs, n_frames, 240, 320, seed=sid)
        dets = synthetic.detections_from_gt(boxes, vis, seed=sid,
                                            frame_hw=(240, 320))
        scenes.append((frames, dets))

    meter = FpsMeter()
    for f in range(n_frames):
        frames = np.stack([scenes[s][0][f] for s in range(n_streams)])
        d = np.zeros((n_streams, 16, 5), np.float32)
        v = np.zeros((n_streams, 16), bool)
        for s in range(n_streams):
            d[s], v[s] = pad_detections(scenes[s][1][f], 16)
        banks, out = serve.multi_stream_step(
            banks, jax.device_put(jnp.asarray(frames), sh),
            jax.device_put(jnp.asarray(d), sh),
            jax.device_put(jnp.asarray(v), sh), cfg)
        meter.tick(n_streams)
        if f % 10 == 9:
            alive = np.asarray(out.n_alive)
            print(f"frame {f + 1}: alive per stream {alive.tolist()}  "
                  f"{meter.stats()}")
    print("done:", meter.stats())

    # --- shared-detector mode (configs[4]'s all-gather batch) ----------
    # Same streams, but the detector runs as ONE batched YOLO forward per
    # frame over every stream's frames (all-gathered across devices), each shard
    # keeping its own streams' detections.
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS

    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, seed=0, max_out=16, score_thr=0.0)

    def detect_fn(params, fr):
        return detect_batch(params, fr, spec, (240, 320), 16, 0.45, 0.0)

    banks2 = serve.make_stream_banks(n_streams, cfg, m)
    frames = np.stack([scenes[s][0][0] for s in range(n_streams)])
    banks2, out2 = serve.detect_then_track_step_shared(
        det.params, banks2, jax.device_put(jnp.asarray(frames), sh), cfg,
        m, detect_fn)
    print("shared-detector step ok: alive per stream",
          np.asarray(out2.n_alive).tolist())

    # --- realistic host ingest: threaded decoders -> batch scheduler ----
    # Each stream "decodes" on its own thread at its own rate into the
    # native StreamScheduler; the device feeder gathers one batch per step
    # (late streams repeat their last frame — serving never blocks).
    import threading
    import time as time_mod

    from jaxmot.native import StreamScheduler

    sched = StreamScheduler(n_streams, frame_shape=(240, 320),
                            capacity=4, dtype=np.uint8)

    def decoder(sid):
        for f in range(n_frames):
            sched.push(sid, (scenes[sid][0][f] * 255).astype(np.uint8))
            time_mod.sleep(0.001 * (1 + sid % 3))   # uneven rates

    threads = [threading.Thread(target=decoder, args=(s,), daemon=True)
               for s in range(n_streams)]
    for t in threads:
        t.start()
    banks3 = serve.make_stream_banks(n_streams, cfg, m)
    steps = 0
    # Loop-invariant: put the constant empty-detection tensors on the
    # mesh once, not per gather step.
    empty_d = jax.device_put(jnp.zeros((n_streams, 16, 5), jnp.float32),
                             sh)
    empty_v = jax.device_put(jnp.zeros((n_streams, 16), bool), sh)
    while steps < 10:
        got = sched.gather()
        if got is None:
            time_mod.sleep(0.001)
            continue
        batch, fresh = got
        banks3, out3 = serve.multi_stream_step(
            banks3, jax.device_put(jnp.asarray(batch), sh),
            empty_d, empty_v, cfg)
        steps += 1
    for t in threads:
        t.join()
    print("scheduler-fed serving ok:", sched.stats())


if __name__ == "__main__":
    main()
