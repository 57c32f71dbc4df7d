"""Where the default tracker chunk spends its device time.

Runs chip_smoke.py's default tracker configuration (1080p, 128 live
objects, 160 detection slots, 64-frame chunks) and reports:

  * steady frames/s with the profiler off;
  * the auction's and the ROI extraction's cost by ablation: the same
    chunk with the assignment replaced by an all-unmatched stub, or the
    ROI sampler by a flat patch (the step is static-shape, so the rest
    of the program does the same work), and the auction's rounds per
    frame (StepOutput.assign_iters; the while_loop runs 3 rounds per
    trip);
  * a profiler trace of two chunks, reduced to device busy/idle share,
    the top device operations and the time under each named scope
    (roi, features, auction) — see reduce_trace.

Usage: python tools/profile_step.py [--out DIR] [--precisions]
The raw trace stays under DIR (default chiprun_out/profile_step).
"""

import argparse
import collections
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _intervals_union(iv):
    total, end = 0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


SCOPES = ("roi", "features", "kcf_detect", "kcf_train", "kalman", "cost",
          "auction")


def _scope_of(name: str, scopes) -> str:
    """The first of `scopes` (innermost stages first) on the op's name
    path, e.g. ".../jit(step)/kcf_detect/roi/..." -> "roi"."""
    parts = name.split("/")
    for sc in scopes:
        if sc in parts:
            return sc
    return "other_named" if name else "unnamed"


def reduce_trace(path: str, top: int = 25, scopes=SCOPES) -> dict:
    """Device-side reduction of one .xplane.pb: the busy share of the
    window spanned by the device's events, the top operations by total
    device time, and the device time per named scope of the tracker step.

    Planes named /device:GPU:<n> are the devices.  Each kernel event
    carries its HLO op's name path in the "name" stat, except kernels
    launched inside a CUDA graph (hlo_op "command_buffer"), which carry
    none: run with XLA_FLAGS=--xla_gpu_enable_command_buffer= to
    attribute every kernel.  An "XLA Ops" line, where present, holds one
    event per executed op; otherwise every stream line is summed."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out = {"planes": [], "devices": {}}
    for plane in pd.planes:
        lines = [ln.name for ln in plane.lines]
        out["planes"].append({"name": plane.name, "lines": lines[:12]})
        if not plane.name.startswith("/device:"):
            continue
        op_lines = [ln for ln in plane.lines if ln.name == "XLA Ops"]
        if not op_lines:
            op_lines = [ln for ln in plane.lines
                        if ln.name not in ("XLA Modules", "Steps")]
        iv, by_name, cnt = [], collections.Counter(), collections.Counter()
        scope_ns = collections.Counter()
        n_graph = 0
        memcpy = collections.Counter()
        for ln in op_lines:
            for ev in ln.events:
                s = int(ev.start_ns)
                d = int(ev.duration_ns)
                iv.append((s, s + d))
                by_name[ev.name] += d
                cnt[ev.name] += 1
                stats = {str(k): str(v) for k, v in ev.stats}
                n_graph += stats.get("hlo_op") == "command_buffer"
                scope_ns[_scope_of(stats.get("name", ""), scopes)] += d
        for ln in plane.lines:
            for ev in ln.events:
                low = ev.name.lower()
                if "memcpy" in low or "dtoh" in low or "htod" in low:
                    memcpy[ev.name] += 1
        if not iv:
            continue
        t0 = min(s for s, _ in iv)
        t1 = max(e for _, e in iv)
        busy = _intervals_union(iv)
        out["devices"][plane.name] = {
            "window_ms": (t1 - t0) / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(t1 - t0, 1),
            "n_events": len(iv),
            "top": [(n, d / 1e6, cnt[n]) for n, d in by_name.most_common(top)],
            "scope_ms": {k: v / 1e6 for k, v in scope_ns.items()},
            "graph_kernels": n_graph,
            "memcpy_events": dict(memcpy.most_common(8)),
            "sample_stats": _sample_stats(op_lines),
        }
    return out


def _sample_stats(op_lines, n=3):
    rows = []
    for ln in op_lines:
        for ev in list(ln.events)[:n]:
            rows.append({"name": ev.name,
                         "stats": {str(k): str(v)[:160]
                                   for k, v in ev.stats}})
        break
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile_step")
    ap.add_argument("--precisions", action="store_true",
                    help="also time the chunk under each kcf_precision")
    args = ap.parse_args()

    from jaxmot.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from jaxmot.config import TrackerConfig
    from jaxmot.ops import patch as patch_ops
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.tracker import step as step_mod

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)
    frames, boxes, vis, _, d, v = chip_smoke.bench_fixture()
    n_frames = frames.shape[0]
    cfg = TrackerConfig(max_tracks=128, max_detections=d.shape[1],
                        frame_height=frames.shape[1],
                        frame_width=frames.shape[2])
    fj, dj, vj = jnp.asarray(frames), jnp.asarray(d), jnp.asarray(v)

    def timed(label, cfg=cfg):
        bank0 = bank_mod.empty_bank(cfg)
        _, secs = chip_smoke.compile_timed(scan.run_sequence, bank0, fj,
                                           dj, vj, cfg)
        state = {"bank": bank0}

        def chunk():
            state["bank"], o = scan.run_sequence(state["bank"], fj, dj, vj,
                                                 cfg)
            state["out"] = o
            return o.boxes

        fps, times = chip_smoke.steady_fps(chunk, n_frames, reps=6)
        _, first = scan.run_sequence(bank0, fj, dj, vj, cfg)
        m = chip_smoke.track_metrics(first, boxes, vis)
        print(json.dumps({"variant": label, "compile_s": round(secs, 2),
                          "fps": fps, "chunk_s": times, **m}), flush=True)
        return fps, state["out"]

    fps, out = timed("shipped")
    iters = np.asarray(out.assign_iters)
    print(json.dumps({"assign_rounds_mean": float(iters.mean()),
                      "assign_rounds_max": int(iters.max()),
                      "while_trips_mean": float(np.mean(
                          np.ceil(iters / 3.0))),
                      "converged": bool(np.asarray(
                          out.assign_converged).all())}), flush=True)

    def ablated(stage, module, attr, stub):
        """The chunk with module.attr replaced by a cheap stub of the
        same output shape: the stage's cost per frame by difference."""
        real = getattr(module, attr)
        setattr(module, attr, stub)
        step_mod.step.clear_cache()
        scan.run_sequence.clear_cache()
        try:
            fps_stub, _ = timed(f"{stage}_stubbed")
        finally:
            setattr(module, attr, real)
            step_mod.step.clear_cache()
            scan.run_sequence.clear_cache()
        print(json.dumps({f"{stage}_ms_per_frame_by_ablation":
                          1e3 / fps - 1e3 / fps_stub}), flush=True)

    def no_assign(cost, feasible):
        return (jnp.full((cost.shape[0],), -1, jnp.int32), jnp.int32(0),
                jnp.bool_(True))

    def flat_patches(img, boxes, padding, size, scales=None):
        # Depends on the frame and the boxes, so nothing is hoisted.
        v = img[0, 0] + 0.0 * boxes[:, :1]
        return jnp.broadcast_to(v[:, :, None], (boxes.shape[0], size, size))

    ablated("auction", step_mod, "auction_assign_stats", no_assign)
    ablated("roi", patch_ops, "extract_patches", flat_patches)

    if args.precisions:
        for mode in ("default", "fwd_high", "high", "highest",
                     "default", "fwd_high"):
            timed(f"kcf_precision={mode}", cfg.replace(kcf_precision=mode))

    # Trace two chunks of the shipped program.
    timed("shipped_retrace")
    bank = bank_mod.empty_bank(cfg)
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(2):
            bank, o = scan.run_sequence(bank, fj, dj, vj, cfg)
            jax.block_until_ready(o.boxes)
    paths = sorted(glob.glob(f"{args.out}/plugins/profile/*/*.xplane.pb"))
    red = reduce_trace(paths[-1])
    red["frames_traced"] = 2 * n_frames
    with open(os.path.join(args.out, "reduced.json"), "w") as f:
        json.dump(red, f, indent=1)
    for name, dv in red["devices"].items():
        print(json.dumps({"device": name, "window_ms": dv["window_ms"],
                          "busy_ms": dv["busy_ms"],
                          "idle_share": dv["idle_share"],
                          "scope_ms": dv["scope_ms"],
                          "memcpy_events": dv["memcpy_events"]}),
              flush=True)
        for n, ms, c in dv["top"][:15]:
            print(f"  {ms:9.3f} ms  x{c:<5d} {n}", flush=True)
    print("planes:", [p["name"] for p in red["planes"]], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
