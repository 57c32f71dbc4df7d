"""Sequence-level tracking: scan the fused step over a frame batch.

The per-frame API (api.MultiTracker) pays one host↔device round trip per
frame.  For offline sequences and throughput serving, the whole clip is
tracked in ONE device program: frames [N, H, W] and padded detections live
in device memory, and
`jax.lax.scan` carries the TrackBank across frames, emitting stacked
per-frame outputs.  This is also the shape the multi-stream serving layer
shards over a mesh (SURVEY.md §3.5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jaxmot.config import TrackerConfig
from jaxmot.tracker import bank as bank_mod
from jaxmot.tracker import step as step_mod


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_sequence(bank, frames: jnp.ndarray, dets: jnp.ndarray,
                 det_valid: jnp.ndarray, cfg: TrackerConfig,
                 frame_valid: jnp.ndarray | None = None):
    """Track a whole clip in one device call.

    bank      : TrackBank carry (use tracker.bank.empty_bank to start).
    frames    : [N, H, W] (or [N, H, W, 3]) image stack.
    dets      : [N, D, 5] padded detections per frame.
    det_valid : [N, D] bool.
    frame_valid : optional [N] bool — False frames are NO-OPS: the bank
        carries through unchanged and the frame's outputs are marked
        invalid.  This lets a short tail chunk be padded up to a fixed
        length instead of compiling a fresh program per remainder shape
        (a compile of this scan costs far more than a padded chunk).
    Returns (final bank, StepOutput stacked over N).
    """
    def body(carry, inp):
        frame, det, valid = inp
        new_bank, out = step_mod.step(carry, frame, det, valid, cfg)
        return new_bank, out

    if frame_valid is None:
        return jax.lax.scan(body, bank, (frames, dets, det_valid),
                            unroll=cfg.scan_unroll)

    def body_masked(carry, inp):
        frame, det, valid, fv = inp
        new_bank, out = step_mod.step(carry, frame, det, valid, cfg)
        # Scalar-predicate select over every bank leaf: padded frames
        # must not age/kill tracks or consume IDs.
        kept = jax.tree.map(lambda a, b: jnp.where(fv, a, b),
                            new_bank, carry)
        out = out._replace(valid=out.valid & fv)
        return kept, out

    return jax.lax.scan(body_masked, bank,
                        (frames, dets, det_valid, frame_valid),
                        unroll=cfg.scan_unroll)


@functools.partial(jax.jit, static_argnames=("cfg", "spec", "stride",
                                             "iou_thr", "score_thr",
                                             "nms_impl"))
def run_sequence_strided_detector(bank, frames: jnp.ndarray, params,
                                  cfg: TrackerConfig, spec, stride: int,
                                  iou_thr: float = 0.45,
                                  score_thr: float = 0.3,
                                  nms_impl: str = "greedy"):
    """Detect-track a clip with the detector run every `stride`-th frame —
    the reference lineage's strided-detection serving mode (SURVEY §3.2:
    "CNN forward; every frame or strided").  Between detector frames the
    KCF correlation keeps tracks locked (step 5's pseudo-measurement
    path), which is exactly why the reference pairs KCF with SORT-style
    association instead of running IoU-only.

    Two lowerings, identical semantics (the detector runs on frames
    where i % stride == 0):

      * N divisible by stride (the common serving-chunk case): the scan
        iterates GROUPS of `stride` frames — the detector runs
        unconditionally on each group's first frame and the remaining
        steps are unrolled with empty detections.  No runtime branch at
        all.
      * otherwise: a lax.cond per frame (XLA conditional — the CNN
        executes only on stride frames, not select-both-branches; the
        scan body carries no batch axis that would degrade it).

    bank   : TrackBank carry.
    frames : [N, H, W] (or [N, H, W, 3]) stack.
    params : detector params dict {"params", "batch_stats"}.
    spec   : models.yolo.YoloSpec (static).
    stride : run the detector on frames where i % stride == 0.
    Returns (final bank, StepOutput stacked over N).
    Equality contract: identical to run_sequence fed detections computed
    at the same stride frames and empty elsewhere
    (tests/test_detector.py::test_strided_detector_equality, both
    lowerings).
    """
    from jaxmot.models.detector import detect_batch

    d_cap = cfg.max_detections
    hw = (cfg.frame_height, cfg.frame_width)
    n = frames.shape[0]

    # Under cfg.class_aware the detector's class ids ride as a 6th
    # column so the tracker's class gate sees them (tracker.step).
    w_cols = 6 if cfg.class_aware else 5

    def with_cls(d, c):
        from jaxmot.models.detector import dets_with_classes
        return dets_with_classes(d, c) if cfg.class_aware else d

    def empty_dets():
        return (jnp.zeros((d_cap, w_cols), jnp.float32),
                jnp.zeros((d_cap,), bool))

    if stride > 1 and n % stride == 0:
        groups = frames.reshape((n // stride, stride) + frames.shape[1:])

        def gbody(b, gframes):
            d, v, c = detect_batch(params, gframes[0][None], spec, hw,
                                   d_cap, iou_thr, score_thr,
                                   nms_impl=nms_impl)
            d = with_cls(d, c)
            b, out0 = step_mod.step(b, gframes[0], d[0], v[0], cfg)
            outs = [out0]
            ed, ev = empty_dets()
            for k in range(1, stride):
                b, o = step_mod.step(b, gframes[k], ed, ev, cfg)
                outs.append(o)
            return b, jax.tree.map(lambda *x: jnp.stack(x), *outs)

        bank, outs = jax.lax.scan(gbody, bank, groups)
        outs = jax.tree.map(
            lambda x: x.reshape((n,) + x.shape[2:]), outs)
        return bank, outs

    def body(carry, frame):
        b, i = carry

        def with_det(_):
            d, v, c = detect_batch(params, frame[None], spec, hw, d_cap,
                                   iou_thr, score_thr, nms_impl=nms_impl)
            return with_cls(d, c)[0], v[0]

        d, v = jax.lax.cond(i % stride == 0, with_det,
                            lambda _: empty_dets(), None)
        nb, out = step_mod.step(b, frame, d, v, cfg)
        return (nb, i + 1), out

    (bank, _), outs = jax.lax.scan(body, (bank, jnp.int32(0)), frames)
    return bank, outs


@functools.partial(jax.jit, static_argnames=("cfg", "spec", "stride",
                                             "iou_thr", "score_thr",
                                             "nms_impl"))
def run_sequence_strided_batched(bank, frames: jnp.ndarray, params,
                                 cfg: TrackerConfig, spec, stride: int,
                                 iou_thr: float = 0.45,
                                 score_thr: float = 0.3,
                                 nms_impl: str = "greedy"):
    """Chunked-serving variant of run_sequence_strided_detector: ALL the
    chunk's detector frames (i % stride == 0) run as ONE batched CNN
    forward, then the tracker scans the full chunk with those detections
    scattered in.

    Numerically identical to the streaming (scanned) form — BatchNorm
    uses running stats at inference so the forward is per-sample
    independent — but the detector runs as one batched forward instead
    of a B=1 forward per frame inside the scan.  Use this for
    chunked/offline serving, the scanned form for frame-by-frame
    streaming arrival.
    """
    from jaxmot.models.detector import detect_batch

    n = frames.shape[0]
    d_cap = cfg.max_detections
    det_frames = frames[::stride]
    d, v, c = detect_batch(params, det_frames, spec,
                           (cfg.frame_height, cfg.frame_width), d_cap,
                           iou_thr, score_thr, nms_impl=nms_impl)
    if cfg.class_aware:
        from jaxmot.models.detector import dets_with_classes
        d = dets_with_classes(d, c)
    idx = jnp.arange(0, n, stride)
    dets = jnp.zeros((n, d_cap, d.shape[-1]), jnp.float32).at[idx].set(d)
    valid = jnp.zeros((n, d_cap), bool).at[idx].set(v)
    return run_sequence(bank, frames, dets, valid, cfg)


def track_sequence(frames, detections, cfg: TrackerConfig | None = None,
                   bank=None, chunk: int | None = None):
    """Host convenience: numpy frames + per-frame detection lists → tracks.

    detections: sequence of [D_f, 4|5|6] arrays (e.g. data.synthetic or a
    MOT det file; a 6th column is a detector class id, cfg.class_aware).
    Returns (final bank, list over frames of
    [(id, (cx, cy, w, h), score)], stacked StepOutput).

    chunk: process the clip in chunks of this many frames (bounds HBM use
    for long videos); outputs are concatenated.
    """
    from jaxmot.tracker.api import pad_detections

    cfg = cfg or TrackerConfig()
    n = len(frames)
    if n == 0:
        # An unreadable/empty video yields a 0-frame stack; return the
        # bank untouched instead of crashing in range(0, 0, 0).
        bank = bank if bank is not None else bank_mod.empty_bank(cfg)
        return bank, [], None
    # Buffer width follows the detections: a 6th (class) column anywhere
    # in the clip promotes the whole buffer so every frame traces with
    # one static shape (5-col frames pad class 0 — the single-class
    # semantics under cfg.class_aware).
    w_cols = max((np.asarray(detections[f]).shape[-1]
                  for f in range(n)
                  if np.asarray(detections[f]).ndim == 2
                  and len(detections[f])), default=5)
    w_cols = 6 if w_cols >= 6 else 5
    d = np.zeros((n, cfg.max_detections, w_cols), np.float32)
    v = np.zeros((n, cfg.max_detections), bool)
    for f in range(n):
        df, v[f] = pad_detections(detections[f], cfg.max_detections)
        d[f, :, : df.shape[-1]] = df
    bank = bank if bank is not None else bank_mod.empty_bank(cfg)

    outs = []
    chunk = chunk or n
    frames = np.asarray(frames)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if hi - lo == chunk:
            bank, out = run_sequence(bank, jnp.asarray(frames[lo:hi]),
                                     jnp.asarray(d[lo:hi]),
                                     jnp.asarray(v[lo:hi]), cfg)
        else:
            # Pad the tail chunk to the full chunk length with masked
            # no-op frames: a bare remainder would be a new static shape
            # and force a second full XLA compile.  The masked program
            # compiles once per chunk size.
            pad = chunk - (hi - lo)
            fv = np.zeros((chunk,), bool)
            fv[: hi - lo] = True
            fpad = np.concatenate(
                [frames[lo:hi],
                 np.zeros((pad,) + frames.shape[1:], frames.dtype)])
            dpad = np.concatenate(
                [d[lo:hi], np.zeros((pad,) + d.shape[1:], d.dtype)])
            vpad = np.concatenate(
                [v[lo:hi], np.zeros((pad,) + v.shape[1:], v.dtype)])
            bank, out = run_sequence(bank, jnp.asarray(fpad),
                                     jnp.asarray(dpad), jnp.asarray(vpad),
                                     cfg, frame_valid=jnp.asarray(fv))
            out = jax.tree.map(lambda a: a[: hi - lo], out)
        outs.append(jax.tree.map(np.asarray, out))
    stacked = jax.tree.map(lambda *xs: np.concatenate(xs, 0), *outs)
    return bank, unpack_outputs(stacked, n), stacked


def unpack_outputs(stacked, n: int):
    """Stacked StepOutput → per-frame [(id, (cx, cy, w, h), score)]."""
    stacked = jax.tree.map(np.asarray, stacked)
    tracks = []
    for f in range(n):
        sel = np.where(stacked.valid[f])[0]
        tracks.append([(int(stacked.ids[f, i]),
                        tuple(float(x) for x in stacked.boxes[f, i]),
                        float(stacked.scores[f, i])) for i in sel])
    return tracks
