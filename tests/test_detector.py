"""YOLO detector tests: NMS vs oracle, decode correctness, end-to-end
shapes, darknet weight-file round trip (SURVEY.md §4.1 parity tier)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jaxmot.models.detector import (YoloDetector, detect_batch,
                                     load_darknet_weights,
                                     _conv_layers_in_call_order)
from jaxmot.models.yolo import (YoloSpec, apply, decode_head,
                                init_variables, network,
                                YOLOV2_TINY_ANCHORS)
from jaxmot.ops import nms as nms_ops

import oracles


def _nms_oracle(boxes, scores, iou_thr, score_thr):
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i] or scores[i] <= score_thr:
            continue
        keep.append(i)
        for j in range(len(boxes)):
            if not suppressed[j] and oracles.iou_xywh(
                    boxes[i], boxes[j]) >= iou_thr:
                suppressed[j] = True
    return keep


def test_nms_matches_oracle():
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(50, 200, (40, 2)),
                            rng.uniform(10, 50, (40, 2))], 1).astype(
                                np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    idx, valid = nms_ops.nms(jnp.asarray(boxes), jnp.asarray(scores),
                             max_out=20, iou_thr=0.5, score_thr=0.1)
    got = [int(i) for i, v in zip(np.asarray(idx), np.asarray(valid)) if v]
    want = _nms_oracle(boxes, scores, 0.5, 0.1)[:20]
    assert got == want


def test_nms_top_k_prefilter_matches_full():
    """The top-K prefilter (bounding the IoU precompute at N=2535 anchor
    counts) must not change results: K >> max_out covers every box that
    could ever be emitted."""
    rng = np.random.default_rng(3)
    n = 600
    boxes = np.concatenate([rng.uniform(50, 400, (n, 2)),
                            rng.uniform(10, 60, (n, 2))], 1).astype(
                                np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
    idx_full, val_full = nms_ops.nms(bj, sj, max_out=16, iou_thr=0.5,
                                     score_thr=0.1, pre_top_k=n)
    idx_pre, val_pre = nms_ops.nms(bj, sj, max_out=16, iou_thr=0.5,
                                   score_thr=0.1)          # default 8*16
    np.testing.assert_array_equal(np.asarray(val_full), np.asarray(val_pre))
    np.testing.assert_array_equal(np.asarray(idx_full), np.asarray(idx_pre))


def test_nms_prefilter_contract_crowded_scene():
    """The documented exactness boundary of the top-K prefilter: a scene
    where greedy suppression inside the top-K exceeds K - max_out starves
    the prefiltered output, and pre_top_k >= N restores exact greedy.
    (Found in the r2 self-review: the old docstring claimed this was
    impossible.)"""
    rng = np.random.default_rng(4)
    max_out = 4
    k_default = 8 * max_out                       # 32
    # 2 clusters x 40 near-identical high-scored boxes: greedy collapses
    # the whole top-32 to 2 keeps (30 suppressed > K - max_out = 28)...
    clusters = []
    for cx in (100.0, 300.0):
        c = np.tile([cx, 100.0, 30.0, 30.0], (40, 1))
        c[:, :2] += rng.uniform(-1, 1, (40, 2))
        clusters.append(c)
    # ...while 4 isolated real detections rank below the top-32.
    iso = np.array([[60.0, 300, 20, 20], [160, 300, 20, 20],
                    [260, 300, 20, 20], [360, 300, 20, 20]])
    boxes = np.concatenate(clusters + [iso]).astype(np.float32)
    scores = np.concatenate([rng.uniform(0.8, 0.9, 80),
                             np.full(4, 0.5)]).astype(np.float32)
    bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
    idx_pre, val_pre = nms_ops.nms(bj, sj, max_out, iou_thr=0.5,
                                   score_thr=0.1)
    idx_full, val_full = nms_ops.nms(bj, sj, max_out, iou_thr=0.5,
                                     score_thr=0.1, pre_top_k=len(boxes))
    # Prefiltered: only the 2 cluster winners survive (output starved).
    assert int(np.asarray(val_pre).sum()) == 2
    # Exact: 2 cluster winners + 2 isolated boxes fill max_out.
    assert int(np.asarray(val_full).sum()) == max_out
    kept_full = set(np.asarray(idx_full)[np.asarray(val_full)].tolist())
    assert len(kept_full & {80, 81, 82, 83}) == 2


def test_nms_classwise_keeps_other_classes():
    boxes = jnp.asarray([[100.0, 100, 20, 20], [102.0, 100, 20, 20]])
    scores = jnp.asarray([0.9, 0.8])
    # Same class: second box suppressed.
    idx, valid = nms_ops.nms_classwise(boxes, scores,
                                       jnp.asarray([0, 0]), 4)
    assert int(np.asarray(valid).sum()) == 1
    # Different classes: both survive.
    idx, valid = nms_ops.nms_classwise(boxes, scores,
                                       jnp.asarray([0, 1]), 4)
    assert int(np.asarray(valid).sum()) == 2


def test_decode_head_known_cell():
    """Craft a logit tensor with one hot cell and check the decoded box."""
    nc, a = 3, 2
    anchors = ((20, 30), (40, 60))
    raw = np.full((1, 4, 4, a * (5 + nc)), -10.0, np.float32)
    # Cell (1, 2), anchor 1: xy logits 0 → offset .5, wh logits 0 → anchor.
    base = 1 * (5 + nc)
    raw[0, 1, 2, base + 0] = 0.0
    raw[0, 1, 2, base + 1] = 0.0
    raw[0, 1, 2, base + 2] = 0.0
    raw[0, 1, 2, base + 3] = 0.0
    raw[0, 1, 2, base + 4] = 10.0      # objectness ~1
    raw[0, 1, 2, base + 5 + 1] = 10.0  # class 1
    boxes, scores, classes = decode_head(jnp.asarray(raw), anchors, 32, nc,
                                         128)
    flat_idx = (1 * 4 + 2) * a + 1
    box = np.asarray(boxes)[0, flat_idx]
    np.testing.assert_allclose(box, [(2 + 0.5) * 32, (1 + 0.5) * 32, 40, 60],
                               rtol=1e-5)
    assert np.asarray(scores)[0, flat_idx] > 0.95
    assert np.asarray(classes)[0, flat_idx] == 1


@pytest.mark.parametrize("variant,n_heads", [("yolov3-tiny", 2),
                                             ("yolov2-tiny", 1),
                                             ("yolov3", 3),
                                             ("yolov2", 1)])
def test_forward_shapes(variant, n_heads):
    size = 96 if variant in ("yolov3", "yolov2") else 160
    spec = YoloSpec(variant, num_classes=4, input_size=size)
    var = init_variables(spec, jax.random.PRNGKey(0), (2, size, size, 3))
    heads = apply(var, jnp.zeros((2, size, size, 3), jnp.float32), spec)
    assert len(heads) == n_heads
    assert heads[0].shape[1] == size // 32
    for head, stride, anchors in zip(heads, spec.strides, spec.anchors):
        assert head.shape[1:] == (size // stride, size // stride,
                                  len(anchors) * (5 + 4))


def test_canonical_anchor_resolution():
    """anchors=None resolves per variant; mismatched overrides rejected."""
    from jaxmot.models.yolo import (YOLOV3_ANCHORS, YOLOV3_TINY_ANCHORS)
    assert YoloSpec("yolov3").anchors == YOLOV3_ANCHORS
    assert YoloSpec("yolov3-tiny").anchors == YOLOV3_TINY_ANCHORS
    assert len(YoloSpec("yolov2").anchors) == 1
    with pytest.raises(ValueError, match="unknown yolo variant"):
        YoloSpec("yolov9000")
    with pytest.raises(ValueError, match="anchor groups"):
        network(YoloSpec("yolov3", anchors=YOLOV3_TINY_ANCHORS))


def test_reorg_space_to_depth_ordering():
    """Passthrough layer: out channel k = (dy*s + dx)*C + c (the ordering
    public v2 weight-conversion ports use)."""
    from jaxmot.models.yolo import _reorg
    x = jnp.arange(2 * 4 * 6 * 3, dtype=jnp.float32).reshape(2, 4, 6, 3)
    r = np.asarray(_reorg(x))
    assert r.shape == (2, 2, 3, 12)
    xn = np.asarray(x)
    for dy in range(2):
        for dx in range(2):
            for c in range(3):
                np.testing.assert_array_equal(
                    r[..., (dy * 2 + dx) * 3 + c], xn[:, dy::2, dx::2, c])


def test_cls_activation_by_lineage():
    """v3-family decodes classes with independent sigmoids, v2-family with
    a softmax — a cell whose class logits are all high must score ~1 under
    sigmoid but ~1/C under softmax."""
    nc, a = 4, 2
    anchors = ((20, 30), (40, 60))
    raw = np.full((1, 2, 2, a * (5 + nc)), -10.0, np.float32)
    raw[0, 0, 0, 4] = 10.0                  # objectness ~1, anchor 0
    raw[0, 0, 0, 5:5 + nc] = 10.0           # every class logit high
    sig = decode_head(jnp.asarray(raw), anchors, 32, nc, 64,
                      cls_act="sigmoid")[1]
    soft = decode_head(jnp.asarray(raw), anchors, 32, nc, 64,
                       cls_act="softmax")[1]
    assert float(sig[0, 0]) > 0.95
    assert abs(float(soft[0, 0]) - 1.0 / nc) < 0.05
    assert YoloSpec("yolov3").cls_activation == "sigmoid"
    assert YoloSpec("yolov3-tiny").cls_activation == "sigmoid"
    assert YoloSpec("yolov2").cls_activation == "softmax"


def test_detect_end_to_end_shapes():
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=96,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=16, score_thr=0.0)
    frames = (np.random.default_rng(0).random((120, 160)) * 255).astype(
        np.uint8)
    dets, valid, classes = det.detect(frames)
    assert dets.shape == (16, 5)
    assert valid.shape == (16,)
    # Boxes come back in frame pixel space.
    assert np.all(dets[valid][:, 0] <= 160 * 2)


@pytest.mark.parametrize("model_name", ["yolov2-tiny", "yolov3-tiny",
                                        "yolov2", "yolov3"])
def test_darknet_weight_roundtrip(tmp_path, model_name):
    """Serialize random darknet-format weights, load, and check exact
    placement (BN folding order, OIHW→HWIO transpose) — for all four
    family members (v3-tiny exercises the two-head routing/upsample layer
    order; full v2 the passthrough-conv interleave; full v3 the 75-conv
    three-head order)."""
    if model_name == "yolov2-tiny":
        spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=96,
                        anchors=YOLOV2_TINY_ANCHORS)
    else:
        spec = YoloSpec(model_name, num_classes=2, input_size=96)
    det = YoloDetector.random_init(spec)
    rng = np.random.default_rng(0)

    chunks = [np.asarray([0, 2, 0], np.int32).tobytes(),
              np.asarray([0], np.int64).tobytes()]
    expected = {}
    params = jax.tree.map(np.asarray, det.params)
    for name, use_bn in _conv_layers_in_call_order(spec):
        conv = params["params"][name]["conv"]
        kh, kw, ci, co = conv["kernel"].shape
        if use_bn:
            for field in ("bias", "scale", "mean", "var"):
                arr = rng.standard_normal(co).astype(np.float32)
                chunks.append(arr.tobytes())
                expected[(name, field)] = arr
        else:
            arr = rng.standard_normal(co).astype(np.float32)
            chunks.append(arr.tobytes())
            expected[(name, "conv_bias")] = arr
        w = rng.standard_normal((co, ci, kh, kw)).astype(np.float32)
        chunks.append(w.tobytes())
        expected[(name, "kernel")] = np.transpose(w, (2, 3, 1, 0))

    path = tmp_path / "w.weights"
    path.write_bytes(b"".join(chunks))
    loaded = load_darknet_weights(spec, str(path))
    loaded = jax.tree.map(np.asarray, loaded)
    for (name, field), want in expected.items():
        if field == "kernel":
            got = loaded["params"][name]["conv"]["kernel"]
        elif field == "conv_bias":
            got = loaded["params"][name]["conv"]["bias"]
        elif field in ("bias", "scale"):
            got = loaded["params"][name]["bn"][field]
        else:
            got = loaded["batch_stats"][name]["bn"][field]
        np.testing.assert_array_equal(got, want, err_msg=f"{name}/{field}")


def test_detector_in_tracker_loop():
    """Full pipeline smoke: random-weight detector feeding MultiTracker —
    the reference's detect-track loop with no precomputed det files."""
    from jaxmot.config import TrackerConfig
    from jaxmot.tracker.api import MultiTracker

    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=96,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.99)
    cfg = TrackerConfig(max_tracks=16, max_detections=8, frame_height=120,
                        frame_width=160)
    mt = MultiTracker(cfg)
    frames = np.random.default_rng(1).random((3, 120, 160)).astype(
        np.float32)
    dets, valid, _ = det.detect(frames[0])
    mt.init(frames[0], dets[valid])
    for f in range(1, 3):
        dets, valid, _ = det.detect(frames[f])
        mt.update(frames[f], dets[valid])


def test_bfloat16_compute_close_to_f32():
    """The bf16 conv path must track the f32 path within bf16
    tolerance on boxes/scores (production serving dtype)."""
    rng = np.random.default_rng(4)
    frames = rng.random((2, 96, 96)).astype(np.float32)
    spec32 = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                      anchors=YOLOV2_TINY_ANCHORS)
    spec16 = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                      anchors=YOLOV2_TINY_ANCHORS, dtype="bfloat16")
    det32 = YoloDetector.random_init(spec32, seed=0, max_out=8,
                                     score_thr=0.0)
    det16 = YoloDetector(spec16, det32.params, max_out=8, score_thr=0.0)
    d32, v32, _ = det32.detect(frames)
    d16, v16, _ = det16.detect(frames)
    assert np.isfinite(d16).all()
    # Same candidate ordering is not guaranteed under quantization; check
    # score agreement of the top detection per frame.
    np.testing.assert_allclose(d16[:, 0, 4], d32[:, 0, 4], atol=0.05)


def test_fast_nms_invariants():
    """fast_nms relaxation: kept set is mutually non-overlapping at the
    threshold (same guarantee as greedy), never larger than greedy's, and
    identical to greedy when no suppression chains exist."""
    rng = np.random.default_rng(5)
    for trial in range(5):
        n = 200
        boxes = np.concatenate([rng.uniform(50, 300, (n, 2)),
                                rng.uniform(10, 50, (n, 2))], 1).astype(
                                    np.float32)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
        # Untruncated (max_out = n) so the subset relation below is exact
        # (with truncation, greedy's superset could lose a low-ranked box
        # that fast's smaller set retains).
        gi, gv = nms_ops.nms(bj, sj, n, 0.5, 0.1, pre_top_k=n)
        fi, fv = nms_ops.fast_nms(bj, sj, n, 0.5, 0.1, pre_top_k=n)
        kept = np.asarray(fi)[np.asarray(fv)]
        # mutual exclusion among fast-kept boxes
        for a in range(len(kept)):
            for b in range(a + 1, len(kept)):
                assert oracles.iou_xywh(boxes[kept[a]],
                                        boxes[kept[b]]) < 0.5
        assert len(kept) <= int(np.asarray(gv).sum())
        # every fast-kept box is also greedy-kept (suppression is only
        # ever MORE aggressive)
        gset = set(np.asarray(gi)[np.asarray(gv)].tolist())
        assert set(kept.tolist()) <= gset

    # Well-separated boxes: both implementations identical.
    boxes = np.asarray([[50, 50, 10, 10], [150, 50, 10, 10],
                        [50, 150, 10, 10]], np.float32)
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    gi, gv = nms_ops.nms(jnp.asarray(boxes), jnp.asarray(scores), 4, 0.5,
                         0.1)
    fi, fv = nms_ops.fast_nms(jnp.asarray(boxes), jnp.asarray(scores), 4,
                              0.5, 0.1)
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(fi))
    np.testing.assert_array_equal(np.asarray(gv), np.asarray(fv))


def test_detect_batch_fast_nms_mode():
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.0,
                                   nms_impl="fast")
    frames = np.random.default_rng(6).random((2, 96, 128)).astype(
        np.float32)
    dets, valid, classes = det.detect(frames)
    assert dets.shape == (2, 8, 5) and np.isfinite(dets).all()


def test_strided_detector_equality():
    """run_sequence_strided_detector == run_sequence fed detections
    computed at the stride frames and empty elsewhere (the lax.cond
    branch must change WHEN the detector runs, nothing else)."""
    from jaxmot.config import TrackerConfig
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.2)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128)
    frames7 = jnp.asarray(np.random.default_rng(2).random(
        (7, 96, 128)).astype(np.float32))
    stride = 3
    # 6 frames: divisible -> grouped (cond-free) lowering; 7 frames:
    # remainder -> per-frame lax.cond lowering.  Both must match the
    # explicit-detections reference.
    for n in (6, 7):
        frames = frames7[:n]
        _run_strided_case(scan, bank_mod, det, cfg, spec, frames, stride,
                          n)


def _run_strided_case(scan, bank_mod, det, cfg, spec, frames, stride, n):
    bank0 = bank_mod.empty_bank(cfg)
    _, out_strided = scan.run_sequence_strided_detector(
        bank0, frames, det.params, cfg, spec, stride, score_thr=0.2)

    dets, valid, _ = detect_batch(det.params, frames, spec, (96, 128), 8,
                                  0.45, 0.2)
    mask = (np.arange(n) % stride) == 0
    dets = np.asarray(dets) * mask[:, None, None]
    valid = np.asarray(valid) & mask[:, None]
    _, out_ref = scan.run_sequence(bank0, frames, jnp.asarray(dets),
                                   jnp.asarray(valid), cfg)

    np.testing.assert_array_equal(np.asarray(out_strided.ids),
                                  np.asarray(out_ref.ids), err_msg=str(n))
    # Boxes agree to float noise: the CNN compiles in a different fusion
    # context inside the scanned cond than standalone-batched (~3e-3 px
    # observed), so assert at pixel-noise level, ids/validity exactly.
    np.testing.assert_allclose(np.asarray(out_strided.boxes),
                               np.asarray(out_ref.boxes), atol=0.05)
    np.testing.assert_array_equal(np.asarray(out_strided.valid),
                                  np.asarray(out_ref.valid))


def test_strided_batched_equality():
    """run_sequence_strided_batched (one batched CNN forward for all the
    chunk's detector frames) == the explicit-detections reference.  The
    forward is per-sample independent (inference BatchNorm), so the only
    allowed divergence from the scanned strided form is float noise from
    the different fusion context."""
    from jaxmot.config import TrackerConfig
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.2)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128)
    frames = jnp.asarray(np.random.default_rng(2).random(
        (7, 96, 128)).astype(np.float32))
    stride = 3
    n = frames.shape[0]

    bank0 = bank_mod.empty_bank(cfg)
    _, out_b = scan.run_sequence_strided_batched(
        bank0, frames, det.params, cfg, spec, stride, score_thr=0.2)

    dets, valid, _ = detect_batch(det.params, frames, spec, (96, 128), 8,
                                  0.45, 0.2)
    mask = (np.arange(n) % stride) == 0
    dets = np.asarray(dets) * mask[:, None, None]
    valid = np.asarray(valid) & mask[:, None]
    _, out_ref = scan.run_sequence(bank0, frames, jnp.asarray(dets),
                                   jnp.asarray(valid), cfg)

    np.testing.assert_array_equal(np.asarray(out_b.ids),
                                  np.asarray(out_ref.ids))
    np.testing.assert_allclose(np.asarray(out_b.boxes),
                               np.asarray(out_ref.boxes), atol=0.05)
    np.testing.assert_array_equal(np.asarray(out_b.valid),
                                  np.asarray(out_ref.valid))


def test_stride2_conv_taps_darknet_alignment():
    """darknet pads k//2 on both sides; XLA SAME pads (0, 1) at stride 2
    — one pixel later.  With a delta kernel at the window center, output
    row j must read input row 2j (darknet), not 2j+1 (SAME)."""
    from jaxmot.models.yolo import _Pass

    x = jnp.arange(8.0).reshape(1, 8, 1, 1).repeat(2, axis=2)
    k = np.zeros((3, 3, 1, 1), np.float32)
    k[1, 1, 0, 0] = 1.0                        # center tap only
    params = {"blk": {"conv": {"kernel": jnp.asarray(k),
                               "bias": jnp.zeros((1,))}}}
    net = _Pass(YoloSpec("yolov3-tiny"), params, {})
    y = net.block(x, 1, 3, stride=2, use_bn=False, act=False, name="blk")
    np.testing.assert_array_equal(np.asarray(y[0, :, 0, 0]),
                                  [0.0, 2.0, 4.0, 6.0])


def test_detector_imports_without_flax():
    """The detector and trainer are plain JAX: importing and running them
    works with flax made unimportable."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "\n".join([
        "import sys",
        "sys.modules['flax'] = None",
        "sys.modules['flax.linen'] = None",
        "import jax",
        "jax.config.update('jax_platforms', 'cpu')",
        "import jaxmot.models.detector as d, jaxmot.parallel.train",
        "from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS",
        "spec = YoloSpec('yolov2-tiny', num_classes=2, input_size=64,",
        "                anchors=YOLOV2_TINY_ANCHORS)",
        "det = d.YoloDetector.random_init(spec, max_out=4)",
        "import numpy as np",
        "out = det.detect(np.zeros((64, 64), np.float32))",
        "assert 'flax' not in [m.split('.')[0] for m in sys.modules",
        "                      if sys.modules[m] is not None]",
        "print('ok', out[0].shape)",
    ])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().startswith("ok (4, 5)")


def test_train_mode_carries_batch_norm_stats():
    """apply(train=True) normalizes with batch statistics and returns the
    updated running statistics explicitly, in the tree of batch_stats:
    new = momentum * old + (1 - momentum) * batch."""
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS, bn_momentum=0.9,
                    stem="direct")
    var = init_variables(spec, jax.random.PRNGKey(0), train=True)
    x = jnp.asarray(np.random.default_rng(0).random((2, 64, 64, 3)),
                    jnp.float32)
    heads, stats = apply(var, x, spec, train=True)
    assert (jax.tree.structure(stats)
            == jax.tree.structure(var["batch_stats"]))
    # First block: batch statistics of its conv output, by hand.
    from jaxmot.models.yolo import conv2d
    y = np.asarray(conv2d(x, var["params"]["ConvBlock_0"]["conv"]["kernel"]),
                   np.float64)
    mean, var_b = y.mean(axis=(0, 1, 2)), y.var(axis=(0, 1, 2))
    got = stats["ConvBlock_0"]["bn"]
    np.testing.assert_allclose(np.asarray(got["mean"]), 0.1 * mean,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got["var"]), 0.9 + 0.1 * var_b,
                               rtol=1e-4, atol=1e-6)
    # Inference with the same variables is untouched by the train pass.
    assert np.asarray(var["batch_stats"]["ConvBlock_0"]["bn"]["mean"]
                      ).max() == 0.0


def test_int8_quantized_inference_close_to_f32():
    """spec.dtype='int8' (dynamic PTQ: per-channel int8 weights,
    per-sample int8 activations, int32 accumulation) serves the SAME
    f32 params — no conversion step — and must reproduce the f32
    detector's raw head maps to quantization tolerance.  (Random heads
    score every box near 0.25, so which boxes NMS keeps is decided by
    last-bit ties; the heads are the stable comparison.)"""
    import optax

    from jaxmot.parallel.train import init_train_state

    spec32 = YoloSpec("yolov3-tiny", num_classes=2, input_size=96)
    det = YoloDetector.random_init(spec32, max_out=8, score_thr=0.05)
    spec8 = YoloSpec("yolov3-tiny", num_classes=2, input_size=96,
                     dtype="int8")
    x = jnp.asarray(np.random.default_rng(0).random(
        (2, 96, 128, 3)).astype(np.float32))
    for h32, h8 in zip(apply(det.params, x, spec32),
                       apply(det.params, x, spec8)):
        h32, h8 = np.asarray(h32), np.asarray(h8)
        assert h8.shape == h32.shape
        assert np.abs(h8 - h32).max() <= 0.1 * np.abs(h32).max()

    frames = x[..., 0]
    d32, v32, _ = detect_batch(det.params, frames, spec32, (96, 128),
                               8, 0.45, 0.05)
    d8, v8, _ = detect_batch(det.params, frames, spec8, (96, 128),
                             8, 0.45, 0.05)
    assert abs(int(np.asarray(v8).sum()) - int(np.asarray(v32).sum())) <= 1
    assert np.isfinite(np.asarray(d8)).all()

    # Training against the int8 path is rejected loudly.
    with pytest.raises(ValueError, match="inference-only"):
        init_train_state(spec8, optax.adam(1e-3))


def test_int8_scale_is_per_sample():
    """A bright frame in the batch must not change its batchmates'
    int8 detections: batched serving equals streaming per frame."""
    spec8 = YoloSpec("yolov3-tiny", num_classes=2, input_size=96,
                     dtype="int8")
    det = YoloDetector.random_init(
        YoloSpec("yolov3-tiny", num_classes=2, input_size=96),
        max_out=8, score_thr=0.05)
    rng = np.random.default_rng(3)
    dim = rng.random((1, 96, 128)).astype(np.float32) * 0.3
    bright = np.ones((1, 96, 128), np.float32)
    both = jnp.asarray(np.concatenate([dim, bright]))
    d_solo, v_solo, _ = detect_batch(det.params, jnp.asarray(dim), spec8,
                                     (96, 128), 8, 0.45, 0.05)
    d_pair, v_pair, _ = detect_batch(det.params, both, spec8,
                                     (96, 128), 8, 0.45, 0.05)
    np.testing.assert_array_equal(np.asarray(v_solo[0]),
                                  np.asarray(v_pair[0]))
    np.testing.assert_allclose(np.asarray(d_solo[0]),
                               np.asarray(d_pair[0]), atol=1e-5)
