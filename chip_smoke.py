"""On-device smoke run of the tracker's main path on one GPU.

    python chip_smoke.py [--seed N]     # every one-card phase
    python chip_smoke.py --cards 4      # the four-card serving path only

Phases (one card):
  tracker_default   scan.run_sequence at 1080p, 128 live objects, 160
                    detection slots, 64-frame chunks (bench.py's fixture)
  tracker_heavy     the same with fHOG-31 (cell 4) and 3-scale search
  api               MultiTracker.init + 10 update calls at 1080p
  detect_track      YOLOv3-tiny (random weights from --seed) at 720p,
                    detect_batch -> run_sequence in one jitted call, at
                    f32, at bf16 with Fast NMS, and int8
  compare           each device result against a plain reference: ROI
                    sampling, KCF train/detect, auction, Kalman, YOLO
                    heads (card vs CPU; int8 vs f32), goldens
  precision         what each DFT precision mode compiles to, and the
                    identical-texture bounce canary per mode

Phase (four cards, --cards 4):
  multicard         8 x 1080p streams, 2 per card, a shared YOLOv3-tiny
                    every 4th frame in both serving modes; the modes
                    against each other and every stream against its own
                    one-card run of scan.run_sequence_strided_detector

Each phase prints its compile seconds, memory analysis and steady
frames/s where it has them.  Any failed phase or missed tolerance raises
and the script exits non-zero.  On a host without a GPU it exits
non-zero before running anything.  The last line of standard output is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

ONE_CARD_PHASES = ("tracker_default", "tracker_heavy", "api",
                   "detect_track", "compare", "precision")
MULTI_CARD_PHASES = ("multicard",)


class ToleranceError(AssertionError):
    """A device result missed its reference by more than its tolerance."""


def select_phases(cards: int) -> tuple:
    """The phases a run with `cards` cards executes."""
    if cards == 1:
        return ONE_CARD_PHASES
    if cards == 4:
        return MULTI_CARD_PHASES
    raise ValueError(f"--cards must be 1 or 4, got {cards}")


def require_gpu(backend: str) -> None:
    """Refuse to run anywhere but on a GPU: a CPU run would measure
    nothing this script reports."""
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; refusing "
            "to run (no result)")


def final_line(devices) -> str:
    """The one-JSON-object last line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_identity() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check(name: str, err: float, tol: float, what: str) -> None:
    """Print one comparison line and raise if err exceeds tol."""
    ok = err <= tol
    print(f"  [{name}] {what}: err={err:.3e} tol={tol:.1e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise ToleranceError(f"{name}: {what} err {err:.3e} > {tol:.1e}")


def check_floor(name: str, value: float, floor: float, what: str) -> None:
    """Print one score line and raise if value is below floor."""
    ok = value >= floor
    print(f"  [{name}] {what}: {value:.4f} floor={floor:g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise ToleranceError(f"{name}: {what} {value:.4f} < {floor:g}")


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (real or complex arrays)."""
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def memory_summary(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def compile_timed(jitted, *args, **kwargs):
    """AOT-compile jitted(*args, **kwargs); returns (compiled, seconds).
    A later call of `jitted` with the same arguments reuses it."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    return compiled, time.perf_counter() - t0


def steady_fps(run_chunk, n_frames: int, reps: int = 4) -> tuple:
    """Median per-chunk seconds over `reps` dependent chunks (each ends
    in block_until_ready) after one warm chunk → (fps, [seconds])."""
    import jax

    run_chunk()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run_chunk())
        times.append(time.perf_counter() - t0)
    return n_frames / float(np.median(times)), times


def track_metrics(out, boxes, vis) -> dict:
    from jaxmot.utils import metrics

    ids = np.asarray(out.ids)
    bxs = np.asarray(out.boxes)
    val = np.asarray(out.valid)
    hyp = [(ids[f, val[f]], bxs[f, val[f]]) for f in range(len(ids))]
    gt = [(np.where(vis[f])[0], boxes[f, vis[f]]) for f in range(len(ids))]
    m = metrics.clear_mot(gt, hyp)
    h = metrics.hota(gt, hyp)
    return {"mota": float(m["mota"]), "idf1": float(m["idf1"]),
            "hota": float(h["hota"])}


# ---------------------------------------------------------------------------
# Phases 1-2: the tracker at 1080p
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def bench_fixture(height=1080, width=1920, n_obj=128, n_frames=64,
                  max_dets=160, seed=0):
    """bench.py's fixture: synthetic objects, uint8 frames, padded
    per-frame detections."""
    from jaxmot.data import synthetic
    from jaxmot.tracker.api import pad_detections

    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(n_obj, height, width, rng, min_size=24,
                                  max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, height, width, seed=seed, noise=0.01)
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=seed,
                                             frame_hw=(height, width))
    d = np.zeros((n_frames, max_dets, 5), np.float32)
    v = np.zeros((n_frames, max_dets), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], max_dets)
    return ((frames * 255).astype(np.uint8), boxes, vis, dets_list, d, v)


def tracker_phase(name: str, kcf=None, fixture=None, min_mota=0.9,
                  reps: int = 4) -> dict:
    import jax
    import jax.numpy as jnp

    from jaxmot.config import KCFConfig, TrackerConfig
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    frames, boxes, vis, _, d, v = fixture or bench_fixture()
    n_frames, height, width = frames.shape
    cfg = TrackerConfig(max_tracks=128, max_detections=d.shape[1],
                        frame_height=height, frame_width=width,
                        kcf=kcf or KCFConfig())
    fj, dj, vj = jnp.asarray(frames), jnp.asarray(d), jnp.asarray(v)
    bank0 = bank_mod.empty_bank(cfg)
    compiled, secs = compile_timed(scan.run_sequence, bank0, fj, dj, vj,
                                   cfg)
    print(f"  [{name}] compile_s: {secs:.2f}", flush=True)
    print(f"  [{name}] memory: {memory_summary(compiled)}", flush=True)
    bank, out = scan.run_sequence(bank0, fj, dj, vj, cfg)
    jax.block_until_ready(out.boxes)
    if not np.isfinite(np.asarray(out.boxes)).all():
        raise ToleranceError(f"{name}: non-finite track boxes")
    m = track_metrics(out, boxes, vis)
    print(f"  [{name}] mota: {m['mota']:.4f} hota: {m['hota']:.4f} "
          f"idf1: {m['idf1']:.4f}", flush=True)
    check_floor(name, m["mota"], min_mota, "MOTA")
    state = {"bank": bank}

    def chunk():
        state["bank"], o = scan.run_sequence(state["bank"], fj, dj, vj, cfg)
        return o.boxes

    fps, times = steady_fps(chunk, n_frames, reps)
    print(f"  [{name}] steady_fps: {fps:.1f} (chunk s: "
          f"{[round(t, 5) for t in times]})", flush=True)
    return {"compile_s": secs, "fps": fps, **m}


def api_phase(fixture=None, n_updates: int = 10) -> dict:
    import jax

    from jaxmot.config import TrackerConfig
    from jaxmot.tracker.api import MultiTracker

    frames, _, _, dets_list, d, _ = fixture or bench_fixture(n_frames=12)
    cfg = TrackerConfig(max_tracks=128, max_detections=d.shape[1],
                        frame_height=frames.shape[1],
                        frame_width=frames.shape[2])
    mt = MultiTracker(cfg)
    t0 = time.perf_counter()
    mt.init(frames[0], dets_list[0])
    jax.block_until_ready(mt.last_output.boxes)
    init_s = time.perf_counter() - t0
    lat = []
    for f in range(1, n_updates + 1):
        t0 = time.perf_counter()
        tracks = mt.update(frames[f], dets_list[f])
        lat.append(time.perf_counter() - t0)
    boxes = np.asarray([b for _, b, _ in tracks], np.float64)
    if not len(tracks) or not np.isfinite(boxes).all():
        raise ToleranceError(f"api: {len(tracks)} tracks / non-finite")
    print(f"  [api] init_s (incl. compile): {init_s:.2f} "
          f"update_ms p50: {1e3 * np.median(lat):.2f} "
          f"confirmed after {n_updates}: {len(tracks)}", flush=True)
    return {"init_s": init_s, "update_ms": 1e3 * float(np.median(lat)),
            "tracks": len(tracks)}


# ---------------------------------------------------------------------------
# Phase 4: YOLOv3-tiny detect + track at 720p
# ---------------------------------------------------------------------------

def spread_head_scores(params, spec, gain: float) -> None:
    """Scale the heads' objectness and class outputs of random weights
    by `gain` (in place; box outputs keep their scale).  Random heads
    put every score near sigmoid(0)^2 = 0.25, so which boxes pass a
    threshold would be decided by ties in the last bits; spread logits
    make the detections follow the image content."""
    import jax.numpy as jnp

    per_anchor = 5 + spec.num_classes
    for name, head in params["params"].items():
        if name.startswith("head"):
            c_out = head["conv"]["kernel"].shape[-1]
            g = jnp.where(jnp.arange(c_out) % per_anchor >= 4, gain, 1.0)
            head["conv"] = {k: v * g for k, v in head["conv"].items()}


def detect_track_phase(seed: int = 0, height=720, width=1280, n_frames=32,
                       max_dets=64, reps: int = 4, head_gain=300.0,
                       score_thr=0.5) -> dict:
    import jax
    import jax.numpy as jnp

    from jaxmot.config import TrackerConfig
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    frames, _, _, _, _, _ = bench_fixture(height, width, n_frames=n_frames,
                                          max_dets=max_dets, seed=seed)
    fj = jnp.asarray(frames)
    cfg = TrackerConfig(max_tracks=128, max_detections=max_dets,
                        frame_height=height, frame_width=width)
    bank0 = bank_mod.empty_bank(cfg)
    results = {}
    for label, dtype, nms in (("f32", "float32", "greedy"),
                              ("bf16_fastnms", "bfloat16", "fast"),
                              ("int8", "int8", "greedy")):
        spec = YoloSpec("yolov3-tiny", num_classes=80, dtype=dtype)
        det = YoloDetector.random_init(spec, seed=seed, max_out=max_dets,
                                       score_thr=score_thr, nms_impl=nms)
        spread_head_scores(det.params, spec, head_gain)

        @jax.jit
        def e2e(params, bank, frames_):
            dets, valid, _ = detect_batch(params, frames_, spec,
                                          (height, width), max_dets, 0.45,
                                          score_thr, nms_impl=nms)
            return scan.run_sequence(bank, frames_, dets, valid, cfg)

        name = f"detect_track_{label}"
        compiled, secs = compile_timed(e2e, det.params, bank0, fj)
        print(f"  [{name}] compile_s: {secs:.2f}", flush=True)
        print(f"  [{name}] memory: {memory_summary(compiled)}", flush=True)
        bank, out = e2e(det.params, bank0, fj)
        boxes = np.asarray(out.boxes)
        if boxes.shape != (n_frames, cfg.max_tracks, 4) or \
                not np.isfinite(boxes).all():
            raise ToleranceError(f"{name}: bad boxes {boxes.shape}")
        state = {"bank": bank}

        def chunk():
            state["bank"], o = e2e(det.params, state["bank"], fj)
            return o.boxes

        fps, times = steady_fps(chunk, n_frames, reps)
        print(f"  [{name}] steady_fps: {fps:.1f} alive_end: "
              f"{int(np.asarray(out.n_alive)[-1])} births: "
              f"{int(np.asarray(out.n_births).sum())}", flush=True)
        results[label] = {"compile_s": secs, "fps": fps}
    return results


# ---------------------------------------------------------------------------
# Phase 5: device results against plain references
# ---------------------------------------------------------------------------

def _oracles():
    tests_dir = os.path.join(REPO, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import oracles
    return oracles


def smooth_frame(height, width, seed=0):
    """A low-gradient test image (|grad| < 0.05 per pixel): float32
    coordinate rounding (~1e-4 px at 1080p) then moves a bilinear sample
    by < 1e-5, while an off-by-one gather moves it by ~1e-2."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width),
                         indexing="ij")
    p = rng.uniform(0, 2 * np.pi, 3)
    f = (0.5 + 0.2 * np.sin(2 * np.pi * xx / 97.0 + p[0])
         * np.cos(2 * np.pi * yy / 61.0 + p[1])
         + 0.1 * np.sin(2 * np.pi * (xx + yy) / 253.0 + p[2])
         + 0.15 * xx / width)
    return f.astype(np.float32)


def roi_boxes(n, height, width, seed=0, big: bool = False):
    """n boxes: a third inside the frame, a third overrunning its border,
    a third (or all with big=True) with windows wider than 128 px."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, 4), np.float32)
    b[:, 0] = rng.uniform(40, width - 40, n)
    b[:, 1] = rng.uniform(40, height - 40, n)
    b[:, 2:] = rng.uniform(12, 40, (n, 2))
    k = n // 3
    b[k:2 * k, 0] = rng.choice([-10.0, width + 10.0], k)
    b[k:2 * k, 1] = rng.uniform(-20, height + 20, k)
    lo = 0 if big else 2 * k
    b[lo:, 2:] = rng.uniform(60, 120, (n - lo, 2))   # 2.5x -> 150-300 px
    return b


def compare_roi(height=1080, width=1920, n=128, u8: bool = False,
                scales=None, seed=0, tol=1e-5, big: bool = False) -> float:
    """ops.patch.extract_patches (on the default device) vs the float64
    bilinear oracle; scales=None is the unit-scale call, a tuple the
    [K*T] scale-batched call of the tracker's scale search."""
    import jax
    import jax.numpy as jnp

    from jaxmot.ops import patch as patch_ops

    oracles = _oracles()
    frame = smooth_frame(height, width, seed)
    if u8:
        frame = np.round(frame * 255).astype(np.uint8)
    boxes = roi_boxes(n, height, width, seed, big)
    if scales is None:
        bx, sc = boxes, None
    else:
        bx = np.tile(boxes, (len(scales), 1))
        sc = np.repeat(np.asarray(scales, np.float32), n)

    @jax.jit
    def run(fr, b, s):
        return patch_ops.extract_patches(patch_ops.to_gray(fr), b, 2.5, 64,
                                         scales=s)

    got = np.asarray(run(jnp.asarray(frame), jnp.asarray(bx),
                         None if sc is None else jnp.asarray(sc)))
    gray = frame.astype(np.float64) / (255.0 if u8 else 1.0)
    want = oracles.roi_patches(gray, bx.astype(np.float64), 2.5, 64,
                               None if sc is None else sc.astype(np.float64))
    err = float(np.max(np.abs(got - want)))
    what = (f"ROI {'u8' if u8 else 'f32'} {height}x{width} T={len(bx)} "
            f"{'unit' if scales is None else f'{len(scales)}-scale'} "
            f"max|err| (f32 gathers + lerps)")
    check("roi", err, tol, what)
    return err


def compare_kcf(n=128, channels=1, precision="highest", tol=1e-4,
                gate: bool = True, seed=0) -> dict:
    """ops.kcf train + detect on the device vs the float64 KCF oracle
    (arXiv:1404.7584 eqs. 17, 22, 31) under one DFT precision mode.

    The features have unit variance under the Hann window, so the kernel
    spectrum stays well away from zero and the spectral divide
    alphaf = yf / (kf + lambda) does not amplify float32 rounding: a
    float32 chain then lands within ~1e-5 of the oracle, and a larger
    error is the arithmetic's, not the conditioning's."""
    import jax
    import jax.numpy as jnp

    from jaxmot.ops import fft as fft_ops
    from jaxmot.ops import kcf as kcf_ops

    oracles = _oracles()
    s, sigma, lam = 64, 0.2, 1e-4
    rng = np.random.default_rng(seed)
    hann = oracles.hann2d(s, s)
    x = (rng.standard_normal((n, channels, s, s)) * hann
         ).astype(np.float32)
    z = (np.roll(x, (3, -2), axis=(2, 3))
         + rng.standard_normal(x.shape) * 0.2 * hann).astype(np.float32)

    def run(xx, zz):
        with fft_ops.precision_scope(precision):
            yf = kcf_ops.make_yf(s, 2.5, 0.125)
            model = kcf_ops.train(xx, yf, sigma, lam)
            return model.alphaf.re, model.alphaf.im, kcf_ops.detect(
                model, zz, sigma)

    are, aim, resp = (np.asarray(a) for a in jax.jit(run)(
        jnp.asarray(x), jnp.asarray(z)))
    yf_full = oracles.KCFOracle(size=s).yf
    want_a = np.empty((n, s, s // 2 + 1), np.complex128)
    want_r = np.empty((n, s, s))
    for t in range(n):
        xt, zt = x[t].astype(np.float64), z[t].astype(np.float64)
        alphaf = yf_full / (np.fft.fft2(
            oracles.gaussian_correlation(xt, xt, sigma)) + lam)
        want_a[t] = alphaf[:, : s // 2 + 1]
        kz = oracles.gaussian_correlation(zt, xt, sigma)
        want_r[t] = np.real(np.fft.ifft2(np.fft.fft2(kz) * alphaf))
    e_train = rel_err(are + 1j * aim, want_a)
    e_detect = rel_err(resp, want_r)
    what = f"KCF C={channels} T={n} precision={precision}"
    if gate:
        check("kcf", e_train, tol, what + " train alphaf rel")
        check("kcf", e_detect, tol, what + " detect response rel")
    else:
        print(f"  [kcf] {what} train rel={e_train:.3e} detect rel="
              f"{e_detect:.3e} (not gated)", flush=True)
    return {"train": e_train, "detect": e_detect}


def auction_problem(n, m, seed):
    """A MOT-shaped association problem: IoU cost of jittered track
    boxes against detections (some clutter), gated at IoU 0.1."""
    import jax.numpy as jnp

    from jaxmot.ops import iou

    rng = np.random.default_rng(seed)
    tracks = np.zeros((n, 4), np.float32)
    tracks[:, 0] = rng.uniform(50, 1800, n)
    tracks[:, 1] = rng.uniform(50, 1000, n)
    tracks[:, 2:] = rng.uniform(24, 64, (n, 2))
    k = min(n, m) * 3 // 4
    dets = np.zeros((m, 4), np.float32)
    dets[:k] = tracks[rng.permutation(n)[:k]] + rng.normal(0, 3, (k, 4))
    dets[k:, 0] = rng.uniform(50, 1800, m - k)
    dets[k:, 1] = rng.uniform(50, 1000, m - k)
    dets[k:, 2:] = rng.uniform(24, 64, (m - k, 2))
    cost = np.asarray(iou.association_cost(
        jnp.asarray(tracks), jnp.asarray(dets), jnp.ones((n,), bool),
        jnp.ones((m,), bool), iou_gate=0.1, infeasible=1e4), np.float32)
    return cost, cost < 1e3


def compare_auction(n=128, m=160, n_problems=20, seed=0) -> float:
    """ops.assignment auction on the device vs scipy's Hungarian:
    equal cardinality, total cost within n*eps of the optimum."""
    import jax
    import jax.numpy as jnp

    from jaxmot.ops import assignment

    solve = jax.jit(assignment.auction_assign_stats)
    worst = 0.0
    for p in range(n_problems):
        cost, feas = auction_problem(n, m, seed + p)
        got, _, conv = solve(jnp.asarray(cost), jnp.asarray(feas))
        got = np.asarray(got)
        want = assignment.scipy_assign(cost, feas)
        if not bool(conv) or (got >= 0).sum() != (want >= 0).sum():
            raise ToleranceError(
                f"auction {n}x{m} #{p}: converged={bool(conv)} "
                f"cardinality {(got >= 0).sum()} vs {(want >= 0).sum()}")
        rows = np.where(got >= 0)[0]
        if not feas[rows, got[rows]].all() or \
                len(set(got[rows])) != len(rows):
            raise ToleranceError(f"auction {n}x{m} #{p}: bad matching")
        gap = (assignment.assignment_cost(cost, got)
               - assignment.assignment_cost(cost, want))
        worst = max(worst, gap)
    check("auction", worst, max(n, m) * assignment.DEFAULT_EPS,
          f"{n_problems} x {n}x{m} total-cost gap to scipy (n*eps)")
    return worst


def compare_kalman(n=128, steps=6, seed=0, rtol=1e-4, atol=1e-3) -> float:
    """ops.kalman predict/correct on the device vs the float64 oracle:
    |got - want| <= rtol*|want| + atol (px), reported as the max ratio."""
    import jax
    import jax.numpy as jnp

    from jaxmot.config import KalmanConfig
    from jaxmot.ops import kalman

    oracles = _oracles()
    cfg = KalmanConfig()
    rng = np.random.default_rng(seed)
    boxes = np.abs(rng.normal(500, 300, (n, 4))).astype(np.float32) + 10
    boxes[:, 2:] = rng.uniform(16, 96, (n, 2))
    predict = jax.jit(lambda m, c: kalman.predict(m, c, cfg))
    correct = jax.jit(lambda m, c, z, g: kalman.correct(m, c, z, g, cfg))
    mean, cov = jax.jit(lambda b: kalman.init(b, cfg))(jnp.asarray(boxes))
    filt = [oracles.KalmanOracle(b) for b in boxes]
    worst = 0.0
    for k in range(steps):
        mean, cov = predict(mean, cov)
        want = np.stack([f.predict() for f in filt])
        got = np.asarray(mean)[:, :4]
        worst = max(worst, float(np.max(np.abs(got - want)
                                        / (rtol * np.abs(want) + atol))))
        z = (boxes + rng.normal(0, 2, boxes.shape)).astype(np.float32)
        gate = np.ones((n,), bool)
        gate[k::steps] = False
        mean, cov = correct(mean, cov, jnp.asarray(z), jnp.asarray(gate))
        got = np.asarray(mean)[:, :4]
        for t in range(n):
            if gate[t]:
                w = filt[t].correct(z[t])
                worst = max(worst, float(np.max(
                    np.abs(got[t] - w) / (rtol * np.abs(w) + atol))))
    check("kalman", worst, 1.0,
          f"T={n} {steps} predict/correct steps, ratio to "
          f"rtol={rtol:g}*|want|+atol={atol:g}")
    return worst


def compare_yolo_heads(seed=0, size=416, batch=2, tol=1e-3) -> float:
    """YOLOv3-tiny raw head maps on the card vs the CPU backend, same
    parameters, both at matmul precision "highest"."""
    import jax
    import jax.numpy as jnp

    from jaxmot.models import yolo

    spec = yolo.YoloSpec("yolov3-tiny", num_classes=80)
    var = yolo.init_variables(spec, jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).random(
        (batch, size, size, 3)).astype(np.float32)
    fwd = jax.jit(lambda v, xx: yolo.apply(v, xx, spec))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        dev = fwd(var, jnp.asarray(x))
        ref = fwd(jax.device_put(var, cpu), jax.device_put(x, cpu))
    err = max(rel_err(a, b) for a, b in zip(dev, ref))
    check("yolo_heads", err, tol,
          f"yolov3-tiny {batch}x{size}^2 heads card vs CPU rel "
          "(precision highest)")
    return err


def compare_yolo_int8(seed=0, size=416, batch=2, tol=0.1) -> float:
    """YOLOv3-tiny int8 raw head maps vs the f32 maps of the same
    parameters, both on the card (f32 at matmul precision "highest"):
    the quantization error relative to the f32 maps' peak."""
    import jax
    import jax.numpy as jnp

    from jaxmot.models import yolo

    spec = yolo.YoloSpec("yolov3-tiny", num_classes=80)
    spec8 = yolo.YoloSpec("yolov3-tiny", num_classes=80, dtype="int8")
    var = yolo.init_variables(spec, jax.random.PRNGKey(seed))
    x = jnp.asarray(np.random.default_rng(seed).random(
        (batch, size, size, 3)).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, xx: yolo.apply(v, xx, spec))(var, x)
    got = jax.jit(lambda v, xx: yolo.apply(v, xx, spec8))(var, x)
    err = max(rel_err(a, b) for a, b in zip(got, ref))
    check("yolo_int8", err, tol,
          f"yolov3-tiny {batch}x{size}^2 int8 heads vs f32 rel "
          "(int8 operands, int32 accumulation)")
    return err


def compare_goldens(mota_tol=0.01) -> dict:
    """tests/golden/*.npz on the device: at kcf_precision="highest" ids
    and valid identical, boxes within 1e-3 px; at the shipped precision
    MOTA within mota_tol of the golden's."""
    _oracles()
    import test_golden
    from jaxmot.utils import metrics

    _, gt_boxes, vis, _ = test_golden.fixture()
    gt = [(np.where(vis[f])[0], gt_boxes[f, vis[f]])
          for f in range(len(vis))]

    def mota(ids, boxes, valid):
        hyp = [(ids[f, valid[f]], boxes[f, valid[f]])
               for f in range(len(ids))]
        return float(metrics.clear_mot(gt, hyp)["mota"])

    res = {}
    for heavy, path in ((False, test_golden.GOLDEN),
                        (True, test_golden.GOLDEN_HEAVY)):
        g = np.load(path)
        label = "heavy" if heavy else "default"
        out = test_golden._run(heavy=heavy, kcf_precision="highest")
        ids_eq = np.array_equal(out.ids, g["ids"])
        val_eq = np.array_equal(out.valid, g["valid"])
        box_err = float(np.max(np.abs(out.boxes - g["boxes"])))
        print(f"  [golden_{label}] highest: ids_equal={ids_eq} "
              f"valid_equal={val_eq}", flush=True)
        if not (ids_eq and val_eq):
            raise ToleranceError(f"golden_{label}: ids/valid differ")
        check(f"golden_{label}", box_err, 1e-3,
              "boxes max|err| px at precision highest")
        shipped = test_golden._run(heavy=heavy)
        m_gold = mota(g["ids"], g["boxes"], g["valid"])
        m_ship = mota(shipped.ids, shipped.boxes, shipped.valid)
        check(f"golden_{label}", abs(m_ship - m_gold), mota_tol,
              f"MOTA shipped {m_ship:.4f} vs golden {m_gold:.4f}")
        res[label] = {"box_err": box_err, "mota": m_ship,
                      "mota_golden": m_gold}
    return res


def compare_phase(seed: int = 0) -> None:
    for u8 in (False, True):
        compare_roi(u8=u8, seed=seed)
        compare_roi(u8=u8, scales=(1 / 1.05, 1.0, 1.05), seed=seed)
    for c in (1, 31):
        compare_kcf(channels=c, precision="highest", seed=seed)
        compare_kcf(channels=c, precision="fwd_high", gate=False, seed=seed)
    compare_auction(seed=seed)
    compare_kalman(seed=seed)
    compare_yolo_heads(seed=seed)
    compare_yolo_int8(seed=seed)
    compare_goldens()


# ---------------------------------------------------------------------------
# Phase 6: precision modes
# ---------------------------------------------------------------------------

def dot_precision_report(seed: int = 0) -> dict:
    """What each jax.lax.Precision compiles to for an f32 DFT-shaped dot
    ([T*S, S] @ [S, S/2+1]) and its error against float64: ~1e-3 means
    TF32 or one bf16 pass, ~1e-6 or below a multi-pass or f32 product."""
    import re

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((128 * 64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 33)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    out = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        f = jax.jit(lambda x, y: jnp.dot(x, y, precision=prec))
        hlo = f.lower(a, b).compile().as_text()
        algo = sorted(set(re.findall(r'"algorithm":"?([A-Z0-9_]+)', hlo)
                          + re.findall(r"algorithm=([a-z0-9_]+)", hlo)))
        target = sorted(set(re.findall(r'custom_call_target="([^"]+)"',
                                       hlo)))
        err = rel_err(f(a, b), want)
        out[name] = {"rel_err": err, "algorithm": algo, "target": target}
        print(f"  [precision] dot {name}: rel_err={err:.3e} "
              f"target={target} algorithm={algo}", flush=True)
    return out


def precision_phase(min_idf1=None) -> dict:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bounce_fixture

    from jaxmot.config import TrackerConfig

    dot_precision_report()
    res = bounce_fixture.run_bounce(bounce_fixture.MODES)
    for mode, r in res.items():
        print(f"  [precision] bounce {mode}: idf1={r['idf1']:.4f} "
              f"idsw={r['idsw']}", flush=True)
    shipped = TrackerConfig().kcf_precision_resolved
    floor = bounce_fixture.MIN_IDF1 if min_idf1 is None else min_idf1
    check_floor("precision", res[shipped]["idf1"], floor,
                f"bounce IDF1 of the shipped mode {shipped!r}")
    return res


# ---------------------------------------------------------------------------
# Four cards: multi-stream serving with a shared detector
# ---------------------------------------------------------------------------

def match_boxes(a, b) -> float:
    """Largest L-inf distance (px) between two box sets matched one to
    one at least total distance; inf when the sets differ in size."""
    if len(a) != len(b):
        return float("inf")
    if not len(a):
        return 0.0
    from scipy.optimize import linear_sum_assignment
    cost = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    r, c = linear_sum_assignment(cost)
    return float(cost[r, c].max())


def stream_diff(a, b) -> dict:
    """How far two tracking outputs of one stream ([T, slots] arrays)
    differ: slot by slot (ids, valid, boxes of slots valid in both), and
    frame by frame as box sets matched without regard to slot."""
    both = a.valid & b.valid
    return {"ids_equal": bool(np.array_equal(a.ids, b.ids)),
            "valid_equal": bool(np.array_equal(a.valid, b.valid)),
            "slot_px": float(np.abs(a.boxes - b.boxes)[both].max(initial=0)),
            "set_px": max(match_boxes(a.boxes[t][a.valid[t]],
                                      b.boxes[t][b.valid[t]])
                          for t in range(a.boxes.shape[0]))}


def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def multicard_phase(n_cards=4, n_streams=8, height=1080, width=1920,
                    n_frames=8, stride=4, max_tracks=128, max_dets=160,
                    spec=None, seed=0, obj_size=(24, 64),
                    head_gain=300.0, score_thr=0.5) -> dict:
    """8 streams, 2 per card, on a 1-D "stream" mesh; a shared detector
    every `stride`-th frame in both modes (all-gather batch, per-shard
    DP).  The modes must agree exactly.  Each stream must equal its own
    one-card run through scan.run_sequence_strided_detector, a program
    that shares no serving code:

      * at "highest" (kcf_precision="highest" and
        jax.default_matmul_precision("highest"), as the goldens are
        compared) slot by slot: ids and valid identical, tracked boxes
        within 1e-2 px;
      * at the shipped precision frame by frame as box sets matched
        without regard to slot, within 1e-2 px.  Two differently
        compiled programs round TF32 convs differently, and near-tied
        detection scores can then swap places, so a birth may take
        another slot while every track is the same.

    For each stream a witness line prints the detections of the two
    programs before tracking and the tracks, each slot by slot and as
    matched box sets.

    Random head weights put every score near sigmoid(0)^2 = 0.25; the
    heads' objectness and class outputs are scaled by `head_gain` so the
    scores spread (box outputs keep their scale)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from jaxmot.config import TrackerConfig
    from jaxmot.data import synthetic
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.parallel import serve
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    devices = jax.devices()[:n_cards]
    if len(devices) != n_cards:
        raise RuntimeError(f"need {n_cards} devices, have "
                           f"{len(jax.devices())}")
    mesh = Mesh(np.asarray(devices), ("stream",))
    spec = spec or YoloSpec("yolov3-tiny", num_classes=80)
    det = YoloDetector.random_init(spec, seed=seed)
    spread_head_scores(det.params, spec, head_gain)
    cfg = TrackerConfig(max_tracks=max_tracks, max_detections=max_dets,
                        frame_height=height, frame_width=width)
    frames = np.empty((n_frames, n_streams, height, width), np.uint8)
    for s in range(n_streams):
        rng = np.random.default_rng(seed + s)
        objs = synthetic.make_objects(max_tracks, height, width, rng,
                                      min_size=obj_size[0],
                                      max_size=obj_size[1])
        fr, _, _ = synthetic.render_sequence(objs, n_frames, height, width,
                                             seed=seed + s, noise=0.01)
        frames[:, s] = (fr * 255).astype(np.uint8)
    detect_fn = functools.partial(detect_batch, spec=spec,
                                  frame_hw=(height, width),
                                  max_out=max_dets, iou_thr=0.45,
                                  score_thr=score_thr)
    params = jax.device_put(det.params, NamedSharding(mesh, P()))
    fj = jax.device_put(jnp.asarray(frames),
                        NamedSharding(mesh, P(None, "stream")))
    one = devices[0]
    p1 = jax.device_put(det.params, one)
    ref_run = jax.jit(scan.run_sequence_strided_detector,
                      static_argnames=("cfg", "spec", "stride", "iou_thr",
                                       "score_thr"))
    serve_detect = jax.jit(detect_fn)

    def serve_run(c, m):
        return serve.multi_stream_sequence_strided(
            params, serve.make_stream_banks(n_streams, c, mesh), fj, c,
            detect_fn, stride, m)

    res = {}
    for mode, m in (("shared", mesh), ("dp", None)):
        compiled, secs = compile_timed(
            serve.multi_stream_sequence_strided, params,
            serve.make_stream_banks(n_streams, cfg, mesh), fj, cfg,
            detect_fn, stride, m)
        print(f"  [multicard_{mode}] compile_s: {secs:.2f}", flush=True)
        print(f"  [multicard_{mode}] memory: {memory_summary(compiled)}",
              flush=True)
        jax.block_until_ready(serve_run(cfg, m)[1].boxes)
        t0 = time.perf_counter()
        _, out = serve_run(cfg, m)
        jax.block_until_ready(out.boxes)
        dt = time.perf_counter() - t0
        fps = n_streams * n_frames / dt
        print(f"  [multicard_{mode}] aggregate_fps: {fps:.1f} "
              f"({n_streams} streams x {n_frames} frames in {dt:.4f} s)",
              flush=True)
        res[mode] = {"compile_s": secs, "fps": fps,
                     "out": jax.tree.map(np.asarray, out)}

    def gate(d, what):
        if not (d["ids_equal"] and d["valid_equal"]):
            raise ToleranceError(f"multicard: {what} ids/valid differ")
        check("multicard", d["slot_px"], 1e-2,
              f"{what}, tracked boxes max|err| px")

    sh, dp = res["shared"].pop("out"), res["dp"].pop("out")
    gate(stream_diff(sh, dp), "shared vs per-shard detector")
    alive = sh.n_alive.max(axis=1).tolist()
    print(f"  [multicard] peak live tracks per stream: {alive}, births: "
          f"{int(sh.n_births.sum())}", flush=True)
    if not sum(alive):
        raise ToleranceError("multicard: no live tracks to compare")
    res["alive"] = alive

    for prec in ("shipped", "highest"):
        ctx = (jax.default_matmul_precision("highest")
               if prec == "highest" else contextlib.nullcontext())
        c = cfg if prec == "shipped" else cfg.replace(
            kcf_precision="highest")
        with ctx:
            out = dp if prec == "shipped" else jax.tree.map(
                np.asarray, serve_run(c, None)[1])
            d_srv, v_srv, _ = jax.tree.map(
                np.asarray, serve_detect(params, fj[0]))
            worst = {}
            for s in range(n_streams):
                f1 = jax.device_put(frames[:, s], one)
                d1, v1, _ = jax.tree.map(np.asarray,
                                         serve_detect(p1, f1[:1]))
                _, o = ref_run(bank_mod.empty_bank(c), f1, p1, cfg=c,
                               spec=spec, stride=stride, iou_thr=0.45,
                               score_thr=score_thr)
                o = jax.tree.map(np.asarray, o)
                trk = stream_diff(o, jax.tree.map(lambda x: x[s], out))
                both = v1[0] & v_srv[s]
                gap = np.abs(d1[0] - d_srv[s])[both]
                det_d = {"valid_equal": bool(np.array_equal(v1[0],
                                                            v_srv[s])),
                         "slot_px": float(gap[:, :4].max(initial=0)),
                         "set_px": match_boxes(d1[0, v1[0], :4],
                                               d_srv[s, v_srv[s], :4]),
                         "score": float(gap[:, 4].max(initial=0))}
                print(f"  [multicard] {prec} stream {s} vs its one-card "
                      f"run: detections {_fmt(det_d)}; tracks {_fmt(trk)}",
                      flush=True)
                for k, v in trk.items():
                    worst[k] = (min(worst.get(k, True), v) if k.endswith(
                        "equal") else max(worst.get(k, 0.0), v))
            res[prec] = worst
            what = f"{prec}: {n_streams} streams vs their one-card runs"
            if prec == "highest":
                gate(worst, what)
            else:
                check("multicard", worst["set_px"], 1e-2,
                      f"{what}, tracked box sets max|err| px")
    return res


PHASES = {
    "tracker_default": lambda a: tracker_phase("tracker_default"),
    "tracker_heavy": lambda a: tracker_phase(
        "tracker_heavy", kcf=_heavy_kcf()),
    "api": lambda a: api_phase(),
    "detect_track": lambda a: detect_track_phase(a.seed),
    "compare": lambda a: compare_phase(a.seed),
    "precision": lambda a: precision_phase(),
    "multicard": lambda a: multicard_phase(a.cards, seed=a.seed),
}


def _heavy_kcf():
    from jaxmot.config import KCFConfig
    return KCFConfig(feature_type="hog", cell_size=4, scale_step=1.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random detector weights and data")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card serving path")
    args = ap.parse_args(argv)
    phases = select_phases(args.cards)

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from jaxmot.utils.cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    import jax

    require_gpu(jax.devices()[0].platform)
    devices = jax.devices()
    if len(devices) < args.cards:
        raise SystemExit(f"chip_smoke: --cards {args.cards} but JAX sees "
                         f"{len(devices)} device(s)")
    print(card_identity(), flush=True)
    print(f"jax {jax.__version__}, devices: {devices}", flush=True)
    t_all = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        PHASES[name](args)
        print(f"== {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"all phases done in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    used = devices[:args.cards]
    print(final_line(used))
    return 0


if __name__ == "__main__":
    sys.exit(main())
