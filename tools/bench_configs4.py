"""BASELINE configs[4] single-device slice: 8 synthetic
1080p streams through the fused detect→track serving step on ONE chip —
both detector modes:

  * dp     — per-shard data-parallel detector (zero collectives);
  * shared — the all-gather → one batched YOLO → scatter path
             (parallel/serve.shared_detector_detect) on a 1-device
             Mesh(("stream",)) where the gather is a no-op but the
             collective program compiles and runs on real hardware.

Reports per-stage ms (detector-only, tracker-only) and aggregate
frames/sec/chip for the fused step in each mode, with the dependent-chain
marginal methodology (see bench.py docstring).  The multi-device version
shards the same program over the stream mesh (chip_smoke.py --cards 4);
this records what one device sustains.

Run:  python tools/bench_configs4.py
Prints one JSON line per mode.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _marginal_ms(chain, n_frames, reps=4):
    chain(1)
    t1 = min(chain(1) for _ in range(2))
    tn = min(chain(reps + 1) for _ in range(2))
    ms = (tn - t1) / reps / n_frames * 1e3
    return ms if ms > 1e-6 else float("nan")


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.parallel import serve
    from jaxmot.tracker import step as step_mod

    height, width = 1080, 1920
    n_streams = 8
    n_frames = 8            # scan length per chain rep (8 streams x 8)
    max_dets = 64

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(64, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, _, _ = synthetic.render_sequence(objs, n_frames, height, width,
                                             seed=0, noise=0.01)
    frames_u8 = (frames * 255).astype(np.uint8)
    # [T, S, H, W]: each stream gets a shifted copy so per-stream work is
    # real and non-identical.
    fj = jnp.asarray(np.stack(
        [np.roll(frames_u8, s * 7, axis=2) for s in range(n_streams)],
        axis=1))

    _stem = os.environ.get("JAXMOT_STEM", "direct")
    spec = YoloSpec("yolov3-tiny", num_classes=80, stem=_stem)
    det = YoloDetector.random_init(spec, max_out=max_dets, score_thr=0.3)
    cfg = TrackerConfig(max_tracks=128, max_detections=max_dets,
                        frame_height=height, frame_width=width)

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("stream",))

    def detect_fn(params, fr):
        return detect_batch(params, fr, spec, (height, width), max_dets,
                            0.45, 0.3)

    banks0 = serve.make_stream_banks(n_streams, cfg, mesh)
    fj = jax.device_put(fj, NamedSharding(mesh, P(None, "stream")))

    # --- fused detect→track, scanned over frames, per mode -------------
    def make_runner(mode):
        def one(banks, frames_s):
            if mode == "shared":
                return serve.detect_then_track_step_shared(
                    det.params, banks, frames_s, cfg, mesh, detect_fn)
            return serve.detect_then_track_step(
                det.params, banks, frames_s, cfg, detect_fn)

        @jax.jit
        def run_seq(banks, fseq):
            def body(b, f):
                b, out = one(b, f)
                return b, out.n_alive
            return jax.lax.scan(body, banks, fseq)
        return run_seq

    results = {}
    for mode in ("dp", "shared"):
        run_seq = make_runner(mode)
        banks, alive = run_seq(banks0, fj)
        jax.block_until_ready(alive)

        def chain(n, _run=run_seq, _banks=banks):
            b = _banks
            t0 = time.perf_counter()
            for _ in range(n):
                b, a = _run(b, fj)
            float(np.asarray(a).sum())
            return time.perf_counter() - t0

        ms = _marginal_ms(chain, n_frames)
        results[mode] = ms
        print(json.dumps({
            "config": "configs4-1chip", "mode": mode,
            "streams": n_streams,
            "ms_per_multistream_step": round(ms, 3),
            "aggregate_fps_per_chip": round(n_streams * 1e3 / ms, 1),
        }), flush=True)

    # --- fast-detector combo + strided serving -------------------------
    # The detector's production levers: bf16 convs + Fast NMS, and the
    # strided-detector chunk (serve.multi_stream_sequence_strided,
    # detector on every 4th multistream frame).
    spec_fast = YoloSpec("yolov3-tiny", num_classes=80, dtype="bfloat16",
                         stem=_stem)
    det_fast = YoloDetector.random_init(spec_fast, max_out=max_dets,
                                        score_thr=0.3)

    def detect_fn_fast(params, fr):
        return detect_batch(params, fr, spec_fast, (height, width),
                            max_dets, 0.45, 0.3, nms_impl="fast")

    @jax.jit
    def run_seq_fast(banks, fseq):
        def body(b, f):
            b, out = serve.detect_then_track_step_shared(
                det_fast.params, b, f, cfg, mesh, detect_fn_fast)
            return b, out.n_alive
        return jax.lax.scan(body, banks, fseq)

    banks, alive = run_seq_fast(banks0, fj)
    jax.block_until_ready(alive)

    def fast_chain(n):
        b = banks
        t0 = time.perf_counter()
        for _ in range(n):
            b, a = run_seq_fast(b, fj)
        float(np.asarray(a).sum())
        return time.perf_counter() - t0

    fast_ms = _marginal_ms(fast_chain, n_frames)
    print(json.dumps({
        "config": "configs4-1chip", "mode": "shared-bf16-fastnms",
        "streams": n_streams,
        "ms_per_multistream_step": round(fast_ms, 3),
        "aggregate_fps_per_chip": round(n_streams * 1e3 / fast_ms, 1),
    }), flush=True)

    stride = 4
    banks, outs = serve.multi_stream_sequence_strided(
        det_fast.params, banks0, fj, cfg, detect_fn_fast, stride,
        mesh=mesh)
    jax.block_until_ready(outs.n_alive)

    def strided_chain(n):
        b = banks
        t0 = time.perf_counter()
        for _ in range(n):
            b, o = serve.multi_stream_sequence_strided(
                det_fast.params, b, fj, cfg, detect_fn_fast, stride,
                mesh=mesh)
        float(np.asarray(o.n_alive).sum())
        return time.perf_counter() - t0

    strided_ms = _marginal_ms(strided_chain, n_frames)
    print(json.dumps({
        "config": "configs4-1chip",
        "mode": f"shared-bf16-fastnms-strided{stride}",
        "streams": n_streams,
        "ms_per_multistream_step": round(strided_ms, 3),
        "aggregate_fps_per_chip": round(n_streams * 1e3 / strided_ms, 1),
    }), flush=True)

    # --- per-stage attribution: detector-only and tracker-only ---------
    @jax.jit
    def det_only_seq(fseq, seed_dets):
        def body(carry, f):
            d, v, _ = detect_fn(det.params, f)
            return carry + jnp.sum(d), (d, v)
        return jax.lax.scan(body, seed_dets, fseq)

    s0 = jnp.zeros((), jnp.float32)
    tot, (d_all, v_all) = det_only_seq(fj, s0)
    jax.block_until_ready(tot)

    def det_chain(n):
        f, s = fj, s0
        t0 = time.perf_counter()
        for _ in range(n):
            s, _ = det_only_seq(f, s)
            f = f ^ jnp.mod(jnp.abs(s), 2.0).astype(f.dtype)
        float(s)
        return time.perf_counter() - t0

    det_ms = _marginal_ms(det_chain, n_frames)

    @jax.jit
    def trk_only_seq(banks, fseq, dseq, vseq):
        def body(b, xs):
            f, dd, vv = xs
            b, out = serve.multi_stream_step(b, f, dd, vv, cfg)
            return b, out.n_alive
        return jax.lax.scan(body, banks, (fseq, dseq, vseq))

    banks, alive = trk_only_seq(banks0, fj, d_all, v_all)
    jax.block_until_ready(alive)

    def trk_chain(n):
        b = banks
        t0 = time.perf_counter()
        for _ in range(n):
            b, a = trk_only_seq(b, fj, d_all, v_all)
        float(np.asarray(a).sum())
        return time.perf_counter() - t0

    trk_ms = _marginal_ms(trk_chain, n_frames)

    print(json.dumps({
        "config": "configs4-1chip", "mode": "stages",
        "detector_ms_per_8stream_step": round(det_ms, 3),
        "tracker_ms_per_8stream_step": round(trk_ms, 3),
        "fused_dp_ms": round(results["dp"], 3),
        "fused_shared_ms": round(results["shared"], 3),
        "device": str(jax.devices()[0]),
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
