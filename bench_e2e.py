"""End-to-end detect+track benchmark — BASELINE configs[3]: "720p video,
full pipeline" with the JAX YOLO in the loop (the config that replaces the
reference's TensorFlow boundary).

bench.py stays the canonical one-JSON-line headline metric (tracking fps
@128 tracks with precomputed detections, matching the driver metric); this
file records the full-pipeline numbers: per-stage ms
and fused detect→track fps at 720p.

Timing methodology: every rep DEPENDS on the previous rep's output (the
tracker bank or a perturbed frame stack carries forward) and the chain
ends with a forced small device→host fetch.  The reported number is the
MARGINAL cost per rep (N-rep chain minus 1-rep chain), which cancels the
fixed per-call dispatch and fetch cost.

Notes on the load: detector weights are random (no darknet weights exist
in this environment), which does not change the detector's cost (same
convs/decode/NMS program), and the tracker's per-frame step is a
static-shape program whose work is identical for 0 or 128 live tracks
(masked slots ride along, SURVEY §7(b)).  Accuracy is bench.py's MOTA
gate's job, in the same session.

Prints ONE JSON line: {"metric", "value", "unit", "extra": {per-stage}}.
"""

import json
import sys
import time


def _marginal_ms(run_chain, n_frames: int, reps: int = 6) -> float:
    """Per-frame marginal ms of one rep: (chain(reps) - chain(1))/(reps-1).
    run_chain(n) must serialize its reps and end with a host fetch."""
    run_chain(1)                                    # warm the chain shape
    t1 = min(run_chain(1) for _ in range(2))
    tn = min(run_chain(reps) for _ in range(2))
    ms = (tn - t1) / (reps - 1) / n_frames * 1e3
    # Keep the reported ms positive/finite.
    return ms if ms > 1e-6 else float("nan")


def main() -> None:
    from jaxmot.utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.tracker.api import pad_detections

    height, width = 720, 1280
    n_frames = 32
    max_dets = 64

    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(128, height, width, rng,
                                  min_size=24, max_size=64, max_speed=3.0)
    frames, gt_boxes, gt_vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=0, noise=0.01)
    # uint8 frames, as video decode delivers them: the detector preprocess
    # and the tracker's ROI path dequantize on device.
    fj = jnp.asarray((frames * 255).astype(np.uint8))
    dets_list = synthetic.detections_from_gt(gt_boxes, gt_vis, seed=0,
                                             frame_hw=(height, width))
    d = np.zeros((n_frames, max_dets, 5), np.float32)
    v = np.zeros((n_frames, max_dets), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], max_dets)
    dj, vj = jnp.asarray(d), jnp.asarray(v)

    # The direct stem, as this benchmark has always timed it; the s2d4
    # stem that stem="auto" picks for inference is compared in its own
    # A/B (ROADMAP S6).
    spec = YoloSpec("yolov3-tiny", num_classes=80, stem="direct")
    det = YoloDetector.random_init(spec, max_out=max_dets, score_thr=0.3)
    cfg = TrackerConfig(max_tracks=128, max_detections=max_dets,
                        frame_height=height, frame_width=width)
    bank0 = bank_mod.empty_bank(cfg)

    # ---- stage 1: detector-only (batched forward + decode + NMS) -------
    @jax.jit
    def detect_once(params, frames):
        dets, valid, _ = detect_batch(params, frames, spec,
                                      (height, width), max_dets, 0.45, 0.3)
        return dets, valid

    def det_chain(n):
        f = fj
        t0 = time.perf_counter()
        for _ in range(n):
            dets, valid = detect_once(det.params, f)
            # Serialize: next rep's frames depend on this rep's output.
            # The perturbation must keep the uint8 dtype — `f + eps`
            # promotes to f32 and silently re-traces/measures the f32
            # detector variant instead of the u8 ingest path.  It must
            # also be genuinely data-dependent: parity-of-sum XOR flips
            # at most the pixel LSB but cannot be constant-folded.
            f = f ^ jnp.mod(jnp.abs(jnp.sum(dets)), 2.0).astype(f.dtype)
        float(jnp.sum(dets))                        # forced fetch
        return time.perf_counter() - t0

    det_ms = _marginal_ms(det_chain, n_frames)

    # ---- stage 2: tracker-only @128 tracks (720p) -----------------------
    def trk_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = scan.run_sequence(bank, fj, dj, vj, cfg)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    trk_ms = _marginal_ms(trk_chain, n_frames)

    # ---- stage 3: fused detect→track, one device program per chunk -----
    @jax.jit
    def e2e_once(params, bank, frames):
        dets, valid, _ = detect_batch(params, frames, spec,
                                      (height, width), max_dets, 0.45, 0.3)
        return scan.run_sequence(bank, frames, dets, valid, cfg)

    def e2e_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = e2e_once(det.params, bank, fj)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    e2e_ms = _marginal_ms(e2e_chain, n_frames)
    e2e_fps = 1e3 / e2e_ms if e2e_ms == e2e_ms else 0.0

    # ---- stage 4: fused e2e with the fast-detector combo ----------------
    # bf16 convs + parallel Fast NMS, combined.
    spec_bf16 = YoloSpec("yolov3-tiny", num_classes=80, dtype="bfloat16",
                         stem="direct")
    det_bf16 = YoloDetector.random_init(spec_bf16, max_out=max_dets,
                                        score_thr=0.3, nms_impl="fast")

    @jax.jit
    def e2e_fast_once(params, bank, frames):
        dets, valid, _ = detect_batch(params, frames, spec_bf16,
                                      (height, width), max_dets, 0.45, 0.3,
                                      nms_impl="fast")
        return scan.run_sequence(bank, frames, dets, valid, cfg)

    def e2e_fast_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = e2e_fast_once(det_bf16.params, bank, fj)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    e2e_fast_ms = _marginal_ms(e2e_fast_chain, n_frames)

    # ---- stage 4b: int8 dynamic-PTQ convs + Fast NMS --------------------
    # Same f32 params served through the int8 path (models/yolo: per-
    # channel int8 weights, per-tensor int8 activations, int32
    # accumulation).
    spec_int8 = YoloSpec("yolov3-tiny", num_classes=80, dtype="int8")

    @jax.jit
    def e2e_int8_once(params, bank, frames):
        dets, valid, _ = detect_batch(params, frames, spec_int8,
                                      (height, width), max_dets, 0.45, 0.3,
                                      nms_impl="fast")
        return scan.run_sequence(bank, frames, dets, valid, cfg)

    def e2e_int8_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = e2e_int8_once(det.params, bank, fj)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    e2e_int8_ms = _marginal_ms(e2e_int8_chain, n_frames)

    # ---- stage 5: strided detection (detector every 3rd frame) ---------
    # The reference lineage's "every frame or strided" serving mode
    # (SURVEY §3.2): the CNN runs in a lax.cond on stride frames, KCF
    # carries tracks between — detector cost amortized by 1/stride.
    from jaxmot.tracker import scan as scan_mod
    stride = 3

    def e2e_strided_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = scan_mod.run_sequence_strided_detector(
                bank, fj, det.params, cfg, spec, stride, score_thr=0.3)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    e2e_strided_ms = _marginal_ms(e2e_strided_chain, n_frames)

    # ---- stage 6: strided + batched detector (chunked serving) ---------
    # Same semantics as stage 5 but ALL the chunk's detector frames run
    # as one batched CNN forward (run_sequence_strided_batched) instead
    # of B=1 forwards inside the scan: the offline/chunked serving shape.
    def e2e_strided_batched_chain(n):
        bank = bank0
        t0 = time.perf_counter()
        for _ in range(n):
            bank, outs = scan_mod.run_sequence_strided_batched(
                bank, fj, det.params, cfg, spec, stride, score_thr=0.3)
        float(np.asarray(outs.n_alive).sum())       # forced fetch
        return time.perf_counter() - t0

    e2e_sb_ms = _marginal_ms(e2e_strided_batched_chain, n_frames)

    print(json.dumps({
        "metric": "720p detect+track full-pipeline frames/sec/chip",
        "value": round(e2e_fps, 1),
        "unit": "frames/sec",
        "extra": {
            "detector_ms_per_frame": round(det_ms, 3),
            "tracker_ms_per_frame_128trk": round(trk_ms, 3),
            "e2e_ms_per_frame": round(e2e_ms, 3),
            "e2e_bf16_fastnms_ms_per_frame": round(e2e_fast_ms, 3),
            "e2e_bf16_fastnms_fps": round(1e3 / e2e_fast_ms, 1),
            "e2e_int8_fastnms_ms_per_frame": round(e2e_int8_ms, 3),
            "e2e_int8_fastnms_fps": round(1e3 / e2e_int8_ms, 1),
            "e2e_strided3_ms_per_frame": round(e2e_strided_ms, 3),
            "e2e_strided3_fps": round(1e3 / e2e_strided_ms, 1),
            "e2e_strided3_batched_ms_per_frame": round(e2e_sb_ms, 3),
            "e2e_strided3_batched_fps": round(1e3 / e2e_sb_ms, 1),
            "detector_fps": round(1e3 / det_ms, 1),
            "tracker_fps": round(1e3 / trk_ms, 1),
            "model": spec.name,
            "timing": "marginal cost per dependent rep",
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
