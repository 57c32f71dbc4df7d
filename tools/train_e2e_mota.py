"""Close the detector-accuracy loop: with no darknet weights at hand,
fine-tune the YOLO on the
synthetic fixture to non-trivial mAP, then run the detect→track pipeline
SCORED against ground truth — the first end-to-end MOTA with the
detector (not precomputed detections) in the loop.

Pipeline: synthetic scenes → parallel.train (optax, BN stats threaded) →
utils.metrics.detection_map on held-out frames → models.detector
detect_batch feeding tracker.scan.run_sequence → utils.metrics.clear_mot.

Run:  python tools/train_e2e_mota.py [--steps N] [--cpu]
Prints one JSON line per phase and a final SUMMARY line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

H, W = 240, 320
INPUT = 256
N_OBJ = 10


def _scenes(seeds, n_frames, n_classes=1):
    from jaxmot.data import synthetic
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        objs = synthetic.make_objects(N_OBJ, H, W, rng, min_size=16,
                                      max_size=40, max_speed=2.5,
                                      n_classes=n_classes)
        frames, boxes, vis = synthetic.render_sequence(
            objs, n_frames, H, W, seed=seed, noise=0.02)
        out.append((frames, boxes, vis,
                    np.asarray([o.cls for o in objs], np.int64)))
    return out


def _to_input_px(boxes):
    """Frame-pixel cxcywh → input-pixel cxcywh (the detector's resize maps
    the full frame onto INPUT x INPUT, anisotropically — train on exactly
    what detect_batch's preprocess produces)."""
    b = np.asarray(boxes, np.float32).copy()
    b[..., 0] *= INPUT / W
    b[..., 2] *= INPUT / W
    b[..., 1] *= INPUT / H
    b[..., 3] *= INPUT / H
    return b



def _iou(a, b):
    """IoU of two cxcywh boxes."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--classes", type=int, default=1,
                    help="detector classes; >1 keys object textures by "
                         "class (data.synthetic families) and adds a "
                         "class-aware vs class-blind tracking comparison")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    ap.add_argument("--save", default=None,
                    help="persist trained params (.npz) here")
    ap.add_argument("--load", default=None,
                    help="skip training; load params saved by --save "
                         "(steps/batch must not matter to the caller)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from jaxmot.config import TrackerConfig
    from jaxmot.models.detector import detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.parallel import train as train_mod
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan
    from jaxmot.utils import checkpoint, metrics

    # Anchors sized for the fixture's 16-40 px objects after the
    # (H, W) → INPUT² resize (x0.8 / x1.07 scale): two heads so nearby
    # objects resolve on the stride-16 grid.
    spec = YoloSpec("yolov3-tiny", num_classes=args.classes, stem="direct",
                    input_size=INPUT,
                    anchors=(((40, 40), (64, 64), (96, 96)),
                             ((12, 12), (20, 20), (30, 30))),
                    bn_momentum=0.9)

    # --- phase 1: train (device-resident scanned loop) -----------------
    # The whole dataset + per-frame targets upload ONCE and a lax.scan
    # runs every step on device (no per-step host round trip).
    train_scenes = _scenes(range(48), 24, args.classes)   # 1152 frames
    frames_all = np.concatenate([s[0] for s in train_scenes])
    boxes_all = np.concatenate([s[1] for s in train_scenes])
    vis_all = np.concatenate([s[2] for s in train_scenes])
    cls_all = np.concatenate([np.tile(s[3], (len(s[0]), 1))
                              for s in train_scenes])
    n_data = len(frames_all)

    tgts_all = train_mod.build_targets(
        spec, _to_input_px(boxes_all), cls_all, vis_all)  # per-head [N,...]
    imgs_all = jax.image.resize(
        jnp.asarray(frames_all)[..., None].repeat(3, -1),
        (n_data, INPUT, INPUT, 3), "bilinear")
    tgts_all = [jnp.asarray(t) for t in tgts_all]
    rng = np.random.default_rng(0)
    batch_idx = jnp.asarray(
        rng.integers(0, n_data, (args.steps, args.batch)), jnp.int32)

    tx = optax.adam(optax.cosine_decay_schedule(1e-3, args.steps, 0.05))
    state = train_mod.init_train_state(spec, tx, seed=0)
    step_fn = train_mod.make_train_step(spec, tx)

    @jax.jit
    def train_all(state, imgs_all, tgts_all, batch_idx):
        def body(st, idx):
            imgs = jnp.take(imgs_all, idx, axis=0)
            tgts = [jnp.take(t, idx, axis=0) for t in tgts_all]
            st, loss = step_fn(st, imgs, tgts)
            return st, loss
        return jax.lax.scan(body, state, batch_idx)

    if args.load:
        params = checkpoint.load_pytree(
            args.load, {"params": state[0], "batch_stats": state[1]})
        print(json.dumps({"phase": "train", "loaded": args.load}),
              flush=True)
    else:
        t0 = time.time()
        state, losses = train_all(state, imgs_all, tgts_all, batch_idx)
        losses = np.asarray(losses)
        params = {"params": state[0], "batch_stats": state[1]}
        print(json.dumps({"phase": "train", "steps": args.steps,
                          "loss_first": round(float(losses[0]), 4),
                          "loss_final": round(float(losses[-1]), 4),
                          "seconds": round(time.time() - t0, 1)}),
              flush=True)
        if args.save:
            checkpoint.save_pytree(args.save, params)

    # --- phase 2: held-out mAP + operating-point selection -------------
    val_scenes = _scenes((100, 101), 12, args.classes)  # 24 held-out
    vframes = np.concatenate([s[0] for s in val_scenes])
    vboxes = np.concatenate([s[1] for s in val_scenes])
    vvis = np.concatenate([s[2] for s in val_scenes])
    vcls = np.concatenate([np.tile(s[3], (len(s[0]), 1))
                           for s in val_scenes])
    dets, valid, classes = detect_batch(
        params, jnp.asarray(vframes), spec, (H, W), 64, 0.45, 0.05)
    dets, valid, classes = (np.asarray(dets), np.asarray(valid),
                            np.asarray(classes))
    pred = [(dets[f, valid[f], :4], dets[f, valid[f], 4],
             classes[f, valid[f]]) for f in range(len(vframes))]
    gt = [(vboxes[f, vvis[f]], vcls[f, vvis[f]])
          for f in range(len(vframes))]
    m_ap = metrics.detection_map(pred, gt, num_classes=args.classes)

    # MOTA ~ 1 - (FP + FN + IDSW)/GT: pick the score threshold that
    # maximizes detection F1 on validation (a low fixed threshold feeds
    # the tracker FP clutter that MOTA punishes; this is the operating
    # point any deployment would tune).
    def det_f1(thr):
        tp = fp = fn = 0
        for f in range(len(vframes)):
            pb = dets[f, valid[f] & (dets[f, :, 4] >= thr), :4]
            gb = vboxes[f, vvis[f]]
            used = np.zeros(len(gb), bool)
            for b in pb:
                ious = [_iou(b, g) for g in gb]
                j = int(np.argmax(ious)) if len(gb) else -1
                if j >= 0 and ious[j] >= 0.5 and not used[j]:
                    used[j] = True
                    tp += 1
                else:
                    fp += 1
            fn += int((~used).sum())
        return 2 * tp / max(2 * tp + fp + fn, 1)

    thrs = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
    f1s = [det_f1(t) for t in thrs]
    best_thr = thrs[int(np.argmax(f1s))]
    print(json.dumps({"phase": "map", "map@50": round(m_ap["map"], 4),
                      "frames": len(vframes),
                      "val_f1_by_thr": {str(t): round(v, 3)
                                        for t, v in zip(thrs, f1s)},
                      "chosen_score_thr": best_thr}), flush=True)

    # --- phase 2b: served-dtype mAP deltas on the TRAINED net ----------
    # Rounding effects that random weights hide show in trained nets:
    # serve the SAME trained params through the bf16 path and report the
    # mAP delta.
    import dataclasses

    def served_map(**repl):
        """mAP@50 of the SAME trained params served through a replaced
        spec (dtype and/or stem) — the end-to-end accuracy gate bf16-class
        changes need (r4 lesson: bf16 corruptions hide from everything
        but trained-net probes)."""
        spec_q = dataclasses.replace(spec, **repl)
        dq, vq, cq = detect_batch(
            params, jnp.asarray(vframes), spec_q, (H, W), 64, 0.45, 0.05)
        dq, vq, cq = np.asarray(dq), np.asarray(vq), np.asarray(cq)
        pred_q = [(dq[f, vq[f], :4], dq[f, vq[f], 4], cq[f, vq[f]])
                  for f in range(len(vframes))]
        m_q = metrics.detection_map(pred_q, gt, num_classes=args.classes)
        return round(m_q["map"], 4)

    quant_maps = {"float32": round(m_ap["map"], 4)}
    quant_maps["bfloat16"] = served_map(dtype="bfloat16")
    print(json.dumps({"phase": "quant_map", "map@50": quant_maps,
                      "delta_bf16": round(
                          quant_maps["bfloat16"] - quant_maps["float32"],
                          4)}), flush=True)

    # The s2d4 stem + the bf16 preprocess (gray resize in the net's
    # compute dtype) gate on the trained net.
    stem_maps = {"f32+s2d4": served_map(stem="s2d4"),
                 "bf16+s2d4": served_map(dtype="bfloat16", stem="s2d4")}
    print(json.dumps({"phase": "stem_map", "map@50": stem_maps,
                      "delta_f32_s2d4": round(
                          stem_maps["f32+s2d4"] - quant_maps["float32"], 4),
                      "delta_bf16_s2d4": round(
                          stem_maps["bf16+s2d4"] - quant_maps["bfloat16"],
                          4)}), flush=True)

    # --- phase 3: e2e detect→track scored MOTA ------------------------
    e2e = _scenes((200,), 40, args.classes)[0]
    eframes, eboxes, evis, ecls = e2e
    max_dets = 32
    # Noisy-detector operating point: emit only recently-matched tracks
    # (SORT's time_since_update gate).  The default output_max_tsu=1e6 is
    # right for the precomputed-dets config (coasting through dropouts is
    # correct there) but amplifies every detector FP into up-to-max_age
    # frames of emitted phantom boxes — the first run measured MOTA -0.24
    # at det-F1 0.64 purely from that amplification.
    dets_e, valid_e, cls_e = detect_batch(
        params, jnp.asarray(eframes), spec, (H, W), max_dets, 0.45,
        best_thr)
    gt_e = [(np.where(evis[f])[0], eboxes[f, np.where(evis[f])[0]])
            for f in range(len(eframes))]

    def track_and_score(class_aware):
        cfg = TrackerConfig(max_tracks=32, max_detections=max_dets,
                            frame_height=H, frame_width=W,
                            output_max_tsu=1, class_aware=class_aware)
        d = dets_e
        if class_aware:
            from jaxmot.models.detector import dets_with_classes
            d = dets_with_classes(dets_e, cls_e)
        bank0 = bank_mod.empty_bank(cfg)
        _, outs = scan.run_sequence(bank0, jnp.asarray(eframes), d,
                                    valid_e, cfg)
        ids_np = np.asarray(outs.ids)
        boxes_np = np.asarray(outs.boxes)
        valid_np = np.asarray(outs.valid)
        hyp = []
        for f in range(len(eframes)):
            sel = np.where(valid_np[f])[0]
            hyp.append((ids_np[f, sel], boxes_np[f, sel]))
        m = metrics.clear_mot(gt_e, hyp)
        m["hota"] = metrics.hota(gt_e, hyp)["hota"]
        return m

    m = track_and_score(class_aware=False)
    summary = {
        "phase": "SUMMARY",
        "metric": "e2e detect+track MOTA with trained detector in loop",
        "classes": args.classes,
        "map@50": round(m_ap["map"], 4),
        "mota": round(m["mota"], 4),
        "idf1": round(m["idf1"], 4),
        "hota": round(m["hota"], 4),
        "idsw": int(m["idsw"]),
        "train_steps": args.steps,
        "device": str(jax.devices()[0]),
    }
    if args.classes > 1:
        ma = track_and_score(class_aware=True)
        summary["class_aware"] = {
            "mota": round(ma["mota"], 4), "idf1": round(ma["idf1"], 4),
            "hota": round(ma["hota"], 4), "idsw": int(ma["idsw"])}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    sys.exit(main())
