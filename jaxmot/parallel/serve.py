"""Multi-stream serving: shard_map the tracking step over a stream mesh.

BASELINE.json configs[4]: 8 concurrent 1080p streams sharded across the
cards of one host, shared detector batch.  Design (SURVEY.md §3.5):

  * Each device owns one (or more) stream's TrackBank — tracker state never
    moves; per-frame tracking is embarrassingly parallel over "stream".
  * The detector runs as ONE batched forward over all streams' frames.
    With replicated detector params this is pure data parallelism (no
    collective — each shard detects its own frames).  With a shared
    detector batch the frames are all-gathered across cards and the
    detections scattered back; both modes
    are expressed below by the sharding of `frames` and the params.

Everything is jit + NamedSharding (GSPMD): XLA inserts the collectives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jaxmot.config import TrackerConfig
from jaxmot.tracker import bank as bank_mod
from jaxmot.tracker import step as step_mod


def make_stream_banks(n_streams: int, cfg: TrackerConfig, mesh: Mesh):
    """One TrackBank per stream, leading axis sharded over the mesh."""
    one = bank_mod.empty_bank(cfg)
    banks = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_streams,) + x.shape), one)
    sharding = NamedSharding(mesh, P("stream"))
    return jax.tree.map(
        lambda x: jax.device_put(x, sharding), banks)


def _fold_classes(dets, classes, cfg: TrackerConfig):
    """Append the detector class column under cfg.class_aware (the [.., 6]
    detection form tracker.step's class gate consumes)."""
    if not cfg.class_aware:
        return dets
    from jaxmot.models.detector import dets_with_classes
    return dets_with_classes(dets, classes)


@functools.partial(jax.jit, static_argnames=("cfg",))
def multi_stream_step(banks, frames: jnp.ndarray, dets: jnp.ndarray,
                      det_valid: jnp.ndarray, cfg: TrackerConfig):
    """One tracking frame for every stream.

    banks     : TrackBank pytree with leading [N_streams] axis (sharded).
    frames    : [N_streams, H, W] — sharded over "stream".
    dets      : [N_streams, D, 5], det_valid [N_streams, D].
    Under jit with stream-sharded inputs, GSPMD partitions the vmap over
    devices — each chip tracks its own streams with zero communication.
    """
    return jax.vmap(lambda b, f, d, v: step_mod.step(b, f, d, v, cfg))(
        banks, frames, dets, det_valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def multi_stream_sequence(banks, frames, dets, det_valid,
                          cfg: TrackerConfig):
    """Track a clip per stream: frames [N_streams, T_frames, H, W]."""
    def per_stream(bank, fr, de, va):
        from jaxmot.tracker import scan
        return scan.run_sequence(bank, fr, de, va, cfg)

    return jax.vmap(per_stream)(banks, frames, dets, det_valid)


@functools.partial(jax.jit, static_argnames=("cfg", "stride",
                                             "detect_fn", "mesh"))
def multi_stream_sequence_strided(detector_params, banks, frames,
                                  cfg: TrackerConfig, detect_fn,
                                  stride: int, mesh: Mesh | None = None):
    """Strided-detector serving over a chunk of multistream frames.

    frames [T, S, H, W] (time-major); the detector runs only on frames
    with t % stride == 0 — the serving-chunk analogue of
    tracker.scan.run_sequence_strided_detector, at the multistream level.
    T must be divisible by stride (serving chunks are sized by the
    caller), which permits the cond-free grouped lowering: the scan
    iterates groups of `stride` frames, the detector runs
    unconditionally on each group head, and the remaining steps are
    unrolled with empty detections — no runtime branch.

    mesh is None  → per-shard-DP detector (zero collectives);
    mesh given    → shared-detector all-gather batch (configs[4] mode).

    Returns (banks, StepOutput stacked [S, T, ...]) — same axis order as
    multi_stream_sequence, against which the equality contract is tested
    (tests/test_parallel.py::test_multistream_strided_equality).
    """
    n = frames.shape[0]
    if stride < 1 or n % stride:
        raise ValueError(
            f"chunk length {n} must be a positive multiple of "
            f"stride {stride}")
    s_streams = frames.shape[1]
    d_cap = cfg.max_detections

    def head_dets(gframes0):
        if mesh is None:
            d, v, c = detect_fn(detector_params, gframes0)
            return _fold_classes(d, c, cfg), v
        return shared_detector_detect(detector_params, gframes0, mesh,
                                      detect_fn,
                                      with_classes=cfg.class_aware)

    groups = frames.reshape((n // stride, stride) + frames.shape[1:])
    empty_d = jnp.zeros((s_streams, d_cap, 6 if cfg.class_aware else 5),
                        jnp.float32)
    empty_v = jnp.zeros((s_streams, d_cap), bool)

    def gbody(b, gframes):
        d, v = head_dets(gframes[0])
        b, out0 = multi_stream_step(b, gframes[0], d, v, cfg)
        outs = [out0]
        for k in range(1, stride):
            b, o = multi_stream_step(b, gframes[k], empty_d, empty_v,
                                     cfg)
            outs.append(o)
        return b, jax.tree.map(lambda *x: jnp.stack(x), *outs)

    banks, outs = jax.lax.scan(gbody, banks, groups)
    # [T//stride, stride, S, ...] → time-major [T, S, ...] → [S, T, ...]
    outs = jax.tree.map(
        lambda x: jnp.swapaxes(x.reshape((n,) + x.shape[2:]), 0, 1), outs)
    return banks, outs


def detect_then_track_step(detector_params, banks, frames, cfg,
                           detect_fn):
    """The fused detect→track serving step, per-shard-DP detector mode.

    detect_fn(params, frames) → (dets [N, D, 5], valid [N, D]); typically
    models.detector.detect_batch closed over the spec.  frames arrive
    stream-sharded; the detector forward is data-parallel over the same
    axis (one batched conv program — XLA keeps it local per shard), then
    each shard's tracker consumes its own detections.  Zero collectives.
    """
    dets, valid, cls = detect_fn(detector_params, frames)
    return multi_stream_step(banks, frames, _fold_classes(dets, cls, cfg),
                             valid, cfg)


def shared_detector_detect(detector_params, frames, mesh: Mesh,
                           detect_fn, with_classes: bool = False):
    """The shared-detector batch of BASELINE configs[4] / SURVEY §3.5:

        all-gather frames  →  ONE batched YOLO forward  →  scatter dets

    expressed as shard_map over the "stream" mesh: each shard all-gathers
    every stream's frames, runs the full-batch detector forward,
    and keeps only its own streams' detections (the scatter is a local
    slice — the data is already resident after the gather).  This is the
    mode to use when the detector runs strided or frames must be batched
    for the matrix units regardless of which card owns the stream; the
    per-shard-DP mode (detect_then_track_step) is the zero-collective
    alternative.  Numerically identical to the DP mode — asserted in
    tests/test_parallel.py on the 8-virtual-CPU mesh and by
    chip_smoke.py --cards 4 on four GPUs.

    detect_fn(params, frames[B,H,W(,3)]) → (dets [B,D,5], valid [B,D],
    classes [B,D]).  Returns (dets, valid) stream-sharded like `frames`;
    with_classes=True appends the class column ([B,D,6] — the
    cfg.class_aware detection form) before the scatter.
    """
    def shard_fn(params, frames_local):
        k = frames_local.shape[0]             # streams per shard (static)
        all_frames = jax.lax.all_gather(frames_local, "stream", axis=0,
                                        tiled=True)
        dets, valid, cls = detect_fn(params, all_frames)
        if with_classes:
            from jaxmot.models.detector import dets_with_classes
            dets = dets_with_classes(dets, cls)
        i = jax.lax.axis_index("stream")
        my_dets = jax.lax.dynamic_slice_in_dim(dets, i * k, k, 0)
        my_valid = jax.lax.dynamic_slice_in_dim(valid, i * k, k, 0)
        return my_dets, my_valid

    # check_vma=False: the NMS while_loop seeds its carry with invariant
    # constants that turn device-varying inside the loop body, which the
    # varying-manual-axes analysis rejects; the computation after the
    # all_gather is replicated by construction, so the check is moot here
    # (and the DP-equality test guards the semantics).
    return jax.shard_map(shard_fn, mesh=mesh,
                         in_specs=(P(), P("stream")),
                         out_specs=(P("stream"), P("stream")),
                         check_vma=False)(
        detector_params, frames)


def detect_then_track_step_shared(detector_params, banks, frames, cfg,
                                  mesh: Mesh, detect_fn):
    """Fused serving step with the shared (all-gathered) detector batch."""
    dets, valid = shared_detector_detect(detector_params, frames, mesh,
                                         detect_fn,
                                         with_classes=cfg.class_aware)
    return multi_stream_step(banks, frames, dets, valid, cfg)


def dryrun_shared_detector(n_devices: int) -> None:
    """Exercise the configs[4] collective path on tiny shapes; raises on
    divergence from the zero-collective DP mode."""
    import numpy as np
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS
    from jaxmot.parallel import mesh as mesh_mod

    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, seed=0, max_out=8, score_thr=0.0)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=64,
                        frame_width=96)
    m = mesh_mod.stream_mesh(n_devices)
    rng = np.random.default_rng(3)
    frames = jnp.asarray(rng.random((n_devices, 64, 96)).astype(np.float32))
    frames = jax.device_put(frames, NamedSharding(m, P("stream")))

    def detect_fn(params, fr):
        return detect_batch(params, fr, spec, (64, 96), 8, 0.45, 0.0)

    banks = make_stream_banks(n_devices, cfg, m)
    banks_s, outs_s = detect_then_track_step_shared(
        det.params, banks, frames, cfg, m, detect_fn)
    jax.block_until_ready(outs_s.boxes)

    banks_d = make_stream_banks(n_devices, cfg, m)
    banks_d, outs_d = detect_then_track_step(det.params, banks_d, frames,
                                             cfg, detect_fn)
    import numpy.testing as npt
    npt.assert_allclose(np.asarray(outs_s.boxes), np.asarray(outs_d.boxes),
                        rtol=1e-5, atol=1e-4)
    npt.assert_array_equal(np.asarray(outs_s.ids), np.asarray(outs_d.ids))
