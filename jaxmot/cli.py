"""Command-line demo drivers — the reference's L5 application layer
(SURVEY.md §1 L5, §3): sequence/video in → tracks out (MOT-format file,
annotated video, metrics).

  python -m jaxmot mot --seq /data/MOT16/train/MOT16-02 --out res.txt
  python -m jaxmot eval --root /data/MOT16/train --out-dir results/
  python -m jaxmot mot --synthetic --score
  python -m jaxmot otb --seq /data/OTB/Basketball --box 198,214,34,81
  python -m jaxmot video --input in.mp4 --weights yolov3-tiny.weights
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--max-tracks", type=int, default=128)
    p.add_argument("--max-dets", type=int, default=64)
    p.add_argument("--no-kcf", action="store_true",
                   help="Kalman+IoU only (detector-driven SORT mode)")
    p.add_argument("--iou-gate", type=float, default=0.3)
    p.add_argument("--out", default=None, help="MOT-format results file")
    p.add_argument("--video-out", default=None, help="annotated video path")
    p.add_argument("--chunk", type=int, default=32,
                   help="frames per device call")
    # Parity-tuning knobs (SURVEY §5: every reference hyper-parameter must
    # be reachable).  Defaults of None fall through to config.py's
    # validated defaults.
    p.add_argument("--appearance-weight", type=float, default=None)
    p.add_argument("--confidence-mode", choices=("peak", "psr"),
                   default=None)
    p.add_argument("--min-psr", type=float, default=None)
    p.add_argument("--n-init", type=int, default=None,
                   help="hits to confirm a track")
    p.add_argument("--max-age", type=int, default=None,
                   help="unmatched frames before a track dies")
    p.add_argument("--feature", choices=("gray", "hog"), default=None)
    p.add_argument("--cell-size", type=int, default=None)
    p.add_argument("--scale-step", type=float, default=None,
                   help="KCF scale pyramid step (1.0 disables)")
    p.add_argument("--interp-factor", type=float, default=None)
    p.add_argument("--kernel-sigma", type=float, default=None)
    p.add_argument("--lambda", dest="lambda_", type=float, default=None)
    p.add_argument("--padding", type=float, default=None,
                   help="KCF context window factor")
    p.add_argument("--train-site", choices=("refined", "detect"),
                   default=None,
                   help="KCF retrain sample site: re-extract at corrected "
                        "boxes (refined, the C lineage's shape) or reuse "
                        "the phase-aligned detect-site spectra (detect, "
                        "no second ROI extraction; see config.py)")
    p.add_argument("--assoc-box",
                   choices=("auto", "refined", "predicted", "best"),
                   default=None,
                   help="track box hypothesis scored in association: "
                        "KCF-refined (default), Kalman prediction (plain "
                        "SORT), or the better IoU of both per pair")


def _make_cfg(args, h, w):
    from jaxmot.config import KCFConfig, TrackerConfig

    kcf_kw = {}
    for arg, field in (("feature", "feature_type"),
                       ("cell_size", "cell_size"),
                       ("scale_step", "scale_step"),
                       ("interp_factor", "interp_factor"),
                       ("kernel_sigma", "kernel_sigma"),
                       ("lambda_", "lambda_"),
                       ("padding", "padding")):
        val = getattr(args, arg, None)
        if val is not None:
            kcf_kw[field] = val
    trk_kw = {}
    for arg in ("appearance_weight", "confidence_mode", "min_psr",
                "n_init", "max_age", "train_site", "class_aware", "assoc_box"):
        val = getattr(args, arg, None)
        if val is not None:
            trk_kw[arg] = val
    if kcf_kw:
        trk_kw["kcf"] = KCFConfig(**kcf_kw)
    return TrackerConfig(max_tracks=args.max_tracks,
                         max_detections=args.max_dets,
                         use_kcf=not args.no_kcf, iou_gate=args.iou_gate,
                         frame_height=h, frame_width=w, **trk_kw)


def cmd_mot(args) -> int:
    from jaxmot.data import mot as mot_data
    from jaxmot.data import synthetic
    from jaxmot.tracker import scan
    from jaxmot.utils import metrics as metrics_mod

    if not args.synthetic and not args.seq:
        print("mot: need --seq <dir> or --synthetic", file=sys.stderr)
        return 2
    if args.synthetic:
        # --frames means "all" for file sequences, but the synthetic
        # fixture has no natural length — default it.
        if args.frames is None:
            args.frames = 100
        rng = np.random.default_rng(args.seed)
        objs = synthetic.make_objects(args.objects, 480, 640, rng)
        frames, gt_boxes, vis = synthetic.render_sequence(
            objs, args.frames, 480, 640, seed=args.seed)
        dets = synthetic.detections_from_gt(gt_boxes, vis, seed=args.seed,
                                            frame_hw=(480, 640))
        gt = [(np.where(vis[f])[0], gt_boxes[f, np.where(vis[f])[0]])
              for f in range(len(frames))]
    else:
        img_dir = os.path.join(args.seq, "img1")
        det_file = os.path.join(args.seq, "det", "det.txt")
        gt_file = os.path.join(args.seq, "gt", "gt.txt")
        frames = mot_data.load_image_sequence(img_dir, limit=args.frames)
        dets = (mot_data.load_mot_dets(det_file, score_min=args.det_min)
                if args.det_min is not None
                else mot_data.load_mot_dets(det_file))
        dets = dets[: len(frames)]
        while len(dets) < len(frames):
            dets.append(np.zeros((0, 5), np.float32))
        gt = (mot_data.load_mot_gt(gt_file, n_frames=len(frames))
              if os.path.exists(gt_file) else None)

    h, w = frames.shape[1:3]
    cfg = _make_cfg(args, h, w)
    t0 = time.perf_counter()
    _, tracks, _ = scan.track_sequence(frames, dets, cfg, chunk=args.chunk)
    dt = time.perf_counter() - t0
    print(f"tracked {len(frames)} frames in {dt:.2f}s "
          f"({len(frames) / dt:.0f} fps)")

    if args.out:
        mot_data.write_mot_results(args.out, tracks)
        print(f"wrote {args.out}")
    if args.video_out:
        from jaxmot.utils.viz import write_video
        write_video(args.video_out, zip(frames, tracks))
        print(f"wrote {args.video_out}")
    if args.score and gt is not None:
        hyp = [(np.asarray([t[0] for t in tr]),
                np.asarray([t[1] for t in tr]).reshape(-1, 4))
               for tr in tracks]
        m = metrics_mod.clear_mot(gt, hyp)
        h = metrics_mod.hota(gt, hyp)
        m.update({k: h[k] for k in ("hota", "deta", "assa", "loca")})
        print(json.dumps({k: round(float(v), 4) for k, v in m.items()}))
    return 0


def cmd_eval(args) -> int:
    """Benchmark-suite evaluation: every MOT sequence under --root is
    tracked with one shared config, per-sequence CLEAR-MOT is printed,
    and the aggregate is the error-sum form MOTA = 1 - sum(fp+fn+idsw)/
    sum(n_gt) (the standard multi-sequence MOTChallenge aggregation, not
    a mean of per-sequence MOTAs)."""
    from jaxmot.data import mot as mot_data
    from jaxmot.tracker import scan
    from jaxmot.utils import metrics as metrics_mod

    seqs = sorted(
        d for d in (os.path.join(args.root, n)
                    for n in os.listdir(args.root))
        if os.path.isdir(os.path.join(d, "img1"))
        and os.path.exists(os.path.join(d, "det", "det.txt")))
    if not seqs:
        print(f"no MOT sequences under {args.root} (need <seq>/img1 + "
              "<seq>/det/det.txt)", file=sys.stderr)
        return 1
    if args.out or args.video_out:
        print("eval: --out/--video-out are ignored — use --out-dir for "
              "per-sequence result files", file=sys.stderr)
    tot = {"fp": 0, "fn": 0, "idsw": 0, "n_gt": 0}
    n_frames_total, t_total = 0, 0.0
    for seq in seqs:
        name = os.path.basename(seq)
        frames = mot_data.load_image_sequence(os.path.join(seq, "img1"),
                                              limit=args.frames)
        det_file = os.path.join(seq, "det", "det.txt")
        dets = (mot_data.load_mot_dets(det_file, score_min=args.det_min)
                if args.det_min is not None
                else mot_data.load_mot_dets(det_file))
        dets = dets[: len(frames)]
        while len(dets) < len(frames):
            dets.append(np.zeros((0, 5), np.float32))
        h, w = frames.shape[1:3]
        cfg = _make_cfg(args, h, w)
        t0 = time.perf_counter()
        _, tracks, _ = scan.track_sequence(frames, dets, cfg,
                                           chunk=args.chunk)
        dt = time.perf_counter() - t0
        n_frames_total += len(frames)
        t_total += dt
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            mot_data.write_mot_results(
                os.path.join(args.out_dir, f"{name}.txt"), tracks)
        gt_file = os.path.join(seq, "gt", "gt.txt")
        if not os.path.exists(gt_file):
            print(json.dumps({"seq": name, "frames": len(frames),
                              "fps": round(len(frames) / dt, 1),
                              "gt": None}))
            continue
        gt = mot_data.load_mot_gt(gt_file, n_frames=len(frames))
        hyp = [(np.asarray([t[0] for t in tr]),
                np.asarray([t[1] for t in tr]).reshape(-1, 4))
               for tr in tracks]
        m = metrics_mod.clear_mot(gt, hyp)
        for k in tot:
            tot[k] += int(m[k])
        print(json.dumps({"seq": name, "frames": len(frames),
                          "fps": round(len(frames) / dt, 1),
                          "mota": round(float(m["mota"]), 4),
                          "hota": round(float(
                              metrics_mod.hota(gt, hyp)["hota"]), 4),
                          "idf1": round(float(m["idf1"]), 4),
                          "fp": int(m["fp"]), "fn": int(m["fn"]),
                          "idsw": int(m["idsw"])}))
    agg_mota = (1.0 - (tot["fp"] + tot["fn"] + tot["idsw"])
                / max(tot["n_gt"], 1))
    print(json.dumps({"seq": "OVERALL", "sequences": len(seqs),
                      "frames": n_frames_total,
                      "fps": round(n_frames_total / max(t_total, 1e-9), 1),
                      "mota": round(agg_mota, 4), **tot}))
    return 0


def cmd_otb(args) -> int:
    from jaxmot.config import KCFConfig
    from jaxmot.data import mot as mot_data
    from jaxmot.tracker.kcf_bank import KCFTracker

    frames = mot_data.load_image_sequence(args.seq, limit=args.frames)
    if len(frames) == 0:
        print(f"otb: no images found in {args.seq} (OTB sequences keep "
              "frames under <seq>/img — point --seq there)",
              file=sys.stderr)
        return 1
    x, y, w, h = (float(v) for v in args.box.split(","))
    box = (x + w / 2, y + h / 2, w, h)          # OTB gt is top-left based
    cfg = KCFConfig(scale_step=args.scale_step)
    tracker = KCFTracker(cfg)
    tracker.init(frames[0], box)
    results = [box]
    t0 = time.perf_counter()
    for f in range(1, len(frames)):
        b, peak = tracker.update(frames[f])
        results.append(tuple(b))
    dt = time.perf_counter() - t0
    print(f"tracked {len(frames) - 1} frames in {dt:.2f}s "
          f"({(len(frames) - 1) / dt:.0f} fps)")
    if args.out:
        with open(args.out, "w") as f:
            for cx, cy, w, h in results:
                f.write(f"{cx - w / 2:.2f},{cy - h / 2:.2f},{w:.2f},"
                        f"{h:.2f}\n")
        print(f"wrote {args.out}")
    if args.gt:
        from jaxmot.utils.metrics import otb_precision
        gt = np.loadtxt(args.gt, delimiter=",", ndmin=2)
        # Score over the overlap: OTB gt files are sometimes shorter than
        # the image sequence (annotation gaps / late start frames).
        k = min(len(gt), len(results))
        gt_c = gt[:k].copy()
        gt_c[:, 0] += gt_c[:, 2] / 2
        gt_c[:, 1] += gt_c[:, 3] / 2
        print(json.dumps(otb_precision(gt_c, np.asarray(results[:k]))))
    return 0


def cmd_video(args) -> int:
    from jaxmot.data.video import read_video, ChunkedVideoPipeline
    from jaxmot.models.detector import YoloDetector
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.tracker import scan, bank as bank_mod

    frames = read_video(args.input, limit=args.frames)
    if frames.size == 0:
        print(f"could not read {args.input}", file=sys.stderr)
        return 1
    h, w = frames.shape[1:3]
    spec = YoloSpec(args.model, num_classes=args.classes,
                    dtype=args.dtype, stem=args.stem)
    if args.weights:
        det = YoloDetector.from_darknet(spec, args.weights,
                                        max_out=args.max_dets,
                                        score_thr=args.det_min)
    else:
        print("warning: no --weights; random-initialized detector "
              "(smoke mode)", file=sys.stderr)
        det = YoloDetector.random_init(spec, max_out=args.max_dets,
                                       score_thr=args.det_min)
    cfg = _make_cfg(args, h, w)

    bank = bank_mod.empty_bank(cfg)
    all_tracks = []
    t0 = time.perf_counter()
    for chunk in ChunkedVideoPipeline(frames, chunk=args.chunk):
        if args.det_stride > 1:
            # Strided detection (SURVEY §3.2 "every frame or strided"):
            # the CNN runs inside a lax.cond every Nth frame; KCF
            # correlation carries tracks between detector frames.
            import jax.numpy as jnp
            bank, outs = scan.run_sequence_strided_detector(
                bank, jnp.asarray(chunk), det.params, cfg, spec,
                args.det_stride,
                score_thr=(args.det_min if args.det_min is not None
                           else 0.3))
            all_tracks.extend(scan.unpack_outputs(outs, len(chunk)))
        else:
            dets, valid, classes = det.detect(chunk)
            if getattr(args, "class_aware", False):
                # The [D, 6] class-aware detection form (one canonical
                # builder — see models.detector.dets_with_classes).
                from jaxmot.models.detector import dets_with_classes
                dets = np.asarray(dets_with_classes(dets, classes))
            dets_list = [d[v] for d, v in zip(dets, valid)]
            bank, tracks, _ = scan.track_sequence(chunk, dets_list, cfg,
                                                  bank=bank)
            all_tracks.extend(tracks)
    dt = time.perf_counter() - t0
    print(f"detect+track {len(frames)} frames in {dt:.2f}s "
          f"({len(frames) / dt:.0f} fps)")
    if args.video_out:
        from jaxmot.utils.viz import write_video
        write_video(args.video_out, zip(frames, all_tracks))
        print(f"wrote {args.video_out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jaxmot", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mot", help="multi-object tracking on a MOT "
                                   "sequence or the synthetic fixture")
    _add_common(p)
    p.add_argument("--seq", help="MOT sequence dir (img1/, det/det.txt)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--objects", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--det-min", type=float, default=None,
                   help="detection score floor; default keeps ALL rows "
                        "(MOT16 DPM scores are often negative)")
    p.add_argument("--score", action="store_true",
                   help="report CLEAR-MOT metrics vs gt")
    p.set_defaults(fn=cmd_mot)

    p = sub.add_parser("eval", help="evaluate every MOT sequence under a "
                                    "root dir; aggregate CLEAR-MOT")
    _add_common(p)
    p.add_argument("--root", required=True,
                   help="dir of MOT sequences (e.g. MOT16/train)")
    p.add_argument("--frames", type=int, default=None,
                   help="per-sequence frame cap")
    p.add_argument("--det-min", type=float, default=None,
                   help="detection score floor; default keeps ALL rows "
                        "(MOT16 DPM scores are often negative)")
    p.add_argument("--out-dir", default=None,
                   help="write <seq>.txt MOT results here")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("otb", help="single-object KCF on an image sequence")
    p.add_argument("--seq", required=True, help="image directory")
    p.add_argument("--box", required=True, help="x,y,w,h first-frame box")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--scale-step", type=float, default=1.0)
    p.add_argument("--gt", default=None,
                   help="OTB groundtruth_rect.txt for precision scoring")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_otb)

    p = sub.add_parser("video", help="detect+track a video file")
    _add_common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--weights", default=None, help="darknet .weights")
    p.add_argument("--model", default="yolov3-tiny")
    p.add_argument("--classes", type=int, default=80)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32", help="served conv dtype")
    p.add_argument("--stem", choices=("auto", "direct", "s2d4"),
                   default="auto",
                   help="early-layer formulation; auto = the exact "
                        "space-to-depth rewrite at inference where "
                        "supported")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--det-min", type=float, default=0.3)
    p.add_argument("--det-stride", type=int, default=1,
                   help="run the detector every Nth frame (lax.cond "
                        "inside the scan; KCF carries tracks between "
                        "detector frames — SURVEY §3.2 strided mode)")
    p.add_argument("--class-aware", action="store_true", default=None,
                   help="gate association by detector class (tracks only "
                        "match detections of their birth class)")
    p.set_defaults(fn=cmd_video)

    args = ap.parse_args(argv)
    if argv is None:
        # Run as the program (not called with an argument list): keep
        # compiled programs across runs (utils/cache.py).
        from jaxmot.utils.cache import enable_compile_cache
        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
