"""Detector training convergence: the YOLO train step must actually learn
on a toy synthetic-rectangle task (single device; DP equivalence is
covered in test_parallel)."""

import numpy as np
import jax.numpy as jnp
import optax

from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS
from jaxmot.parallel import train


def _toy_batch(rng, b=4, s=64):
    images = rng.random((b, s, s, 3)).astype(np.float32) * 0.2
    gt_boxes = np.zeros((b, 1, 4), np.float32)
    for i in range(b):
        cx, cy = rng.uniform(16, 48, 2)
        w, h = rng.uniform(12, 20, 2)
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        images[i, y0:y1, x0:x1] = 0.9
        gt_boxes[i, 0] = (cx, cy, w, h)
    gt_classes = np.zeros((b, 1), int)
    gt_valid = np.ones((b, 1), bool)
    return images, gt_boxes, gt_classes, gt_valid


def test_loss_decreases():
    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    tx = optax.adam(1e-3)
    state = train.init_train_state(spec, tx, seed=0)
    step = train.make_train_step(spec, tx)

    rng = np.random.default_rng(0)
    images, gb, gc, gv = _toy_batch(rng)
    targets = [jnp.asarray(t) for t in train.build_targets(spec, gb, gc, gv)]
    imgs = jnp.asarray(images)

    losses = []
    for _ in range(25):
        state, loss = step(state, imgs, targets)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def _build_targets_loop_oracle(spec, gt_boxes, gt_classes, gt_valid):
    """The original per-GT Python loop formulation, kept as the oracle for
    the vectorized scatter in parallel/train.py."""
    s = spec.input_size
    out = []
    b, m = gt_valid.shape
    for anchors, stride in zip(spec.anchors, spec.strides):
        hg = wg = s // stride
        a = len(anchors)
        tgt = np.zeros((b, hg, wg, a, 5 + spec.num_classes), np.float32)
        areas = np.asarray([aw * ah for aw, ah in anchors])
        for bi in range(b):
            for mi in range(m):
                if not gt_valid[bi, mi]:
                    continue
                cx, cy, w, h = gt_boxes[bi, mi]
                gx = min(int(cx // stride), wg - 1)
                gy = min(int(cy // stride), hg - 1)
                ai = int(np.argmin(np.abs(areas - w * h)))
                tgt[bi, gy, gx, ai, 0] = cx / stride - gx
                tgt[bi, gy, gx, ai, 1] = cy / stride - gy
                tgt[bi, gy, gx, ai, 2] = np.log(max(w, 1.0) / anchors[ai][0])
                tgt[bi, gy, gx, ai, 3] = np.log(max(h, 1.0) / anchors[ai][1])
                tgt[bi, gy, gx, ai, 4] = 1.0
                tgt[bi, gy, gx, ai, 5 + int(gt_classes[bi, mi])] = 1.0
        out.append(tgt)
    return out


def test_build_targets_vectorized_matches_loop_oracle():
    spec = YoloSpec("yolov2-tiny", num_classes=3, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    rng = np.random.default_rng(5)
    b, m = 6, 7
    gb = np.zeros((b, m, 4), np.float32)
    gb[..., :2] = rng.uniform(2, 62, (b, m, 2))
    gb[..., 2:] = rng.uniform(4, 40, (b, m, 2))
    gc = rng.integers(0, 3, (b, m))
    gv = rng.random((b, m)) > 0.3
    got = train.build_targets(spec, gb, gc, gv)
    want = _build_targets_loop_oracle(spec, gb, gc, gv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_detection_map_hand_cases():
    """VOC AP on hand-built cases with known values."""
    from jaxmot.utils.metrics import detection_map

    g = [30.0, 30.0, 10.0, 10.0]
    far = [80.0, 80.0, 10.0, 10.0]
    # Perfect single detection -> AP = 1.
    m = detection_map([( [g], [0.9], [0] )], [( [g], [0] )], num_classes=1)
    assert m["map"] == 1.0
    # One TP at score .9 + one FP at score .8, one GT:
    # PR points: (r=1, p=1) then (r=1, p=.5) -> AP = 1.0.
    m = detection_map([([g, far], [0.9, 0.8], [0, 0])], [([g], [0])], 1)
    assert m["map"] == 1.0
    # FP ranked ABOVE the TP: points (r=0, p=0), (r=1, p=.5) -> AP = 0.5.
    m = detection_map([([far, g], [0.9, 0.8], [0, 0])], [([g], [0])], 1)
    np.testing.assert_allclose(m["map"], 0.5)
    # Two GTs, one detected -> recall caps at 0.5: AP = 0.5.
    m = detection_map([([g], [0.9], [0])], [([g, far], [0, 0])], 1)
    np.testing.assert_allclose(m["map"], 0.5)
    # Class present in GT but never predicted -> AP 0 for it; mean over
    # the two classes = (1 + 0) / 2.
    m = detection_map([([g], [0.9], [0])], [([g, far], [0, 1])], 2)
    np.testing.assert_allclose(m["map"], 0.5)
    assert m["ap_per_class"] == [1.0, 0.0]
    # Duplicate detection of one GT: second is FP (greedy one-to-one).
    m = detection_map([([g, g], [0.9, 0.8], [0, 0])], [([g], [0])], 1)
    np.testing.assert_allclose(m["map"], 1.0)   # TP first: envelope holds


def test_training_lifts_map():
    """Detector quality signal beyond the loss: on
    the toy overfit task, mAP@0.5 goes from 0.0 (random init detects
    nothing above threshold) to a real score.  Measured 0.55 after 150
    adam steps; asserted loosely for CI stability."""
    from jaxmot.models.detector import detect_batch
    from jaxmot.utils.metrics import detection_map

    # bn_momentum=0.9: at the darknet default 0.99 the BN running stats
    # need thousands of steps to converge to the batch statistics the
    # train-mode network learned against; this 150-step toy run needs
    # the faster constant (see YoloSpec.bn_momentum).
    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS, bn_momentum=0.9)
    tx = optax.adam(2e-3)
    state = train.init_train_state(spec, tx, seed=0)
    step = train.make_train_step(spec, tx)
    rng = np.random.default_rng(0)
    images, gb, gc, gv = _toy_batch(rng, b=8)
    targets = [jnp.asarray(t) for t in train.build_targets(spec, gb, gc,
                                                           gv)]
    imgs = jnp.asarray(images)

    def eval_map(params, bs):
        dets, valid, classes = detect_batch(
            {"params": params, "batch_stats": bs}, imgs, spec, (64, 64),
            8, 0.45, 0.1)
        preds, gts = [], []
        for i in range(len(images)):
            m = np.asarray(valid[i])
            preds.append((np.asarray(dets[i])[m, :4],
                          np.asarray(dets[i])[m, 4],
                          np.asarray(classes[i])[m]))
            gts.append((gb[i][gv[i]], gc[i][gv[i]]))
        return detection_map(preds, gts, num_classes=1)["map"]

    map0 = eval_map(state[0], state[1])
    # 300 steps: with real batch normalization (r2 — BN now trains) the
    # toy run crosses ~0.88 mAP at 300 steps but only ~0.04 at 150
    # (probed 2026-08-17); the pre-r2 model converged faster because its
    # BN was an affine no-op.
    for _ in range(300):
        state, _ = step(state, imgs, targets)
    map1 = eval_map(state[0], state[1])
    assert map1 > max(map0 + 0.2, 0.3), (map0, map1)


def test_targets_structure():
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    gb = np.asarray([[[32.0, 32.0, 16.0, 16.0]]], np.float32)
    gc = np.asarray([[1]])
    gv = np.ones((1, 1), bool)
    (tgt,) = train.build_targets(spec, gb, gc, gv)
    assert tgt.shape == (1, 2, 2, 5, 7)      # 64/32=2 grid, 5 anchors
    assert tgt[..., 4].sum() == 1.0          # one responsible cell
    gy, gx = 1, 1
    cell = tgt[0, gy, gx]
    ai = int(np.argmax(cell[:, 4]))
    assert cell[ai, 5 + 1] == 1.0            # class one-hot
