"""Multi-chip sharding tests on the 8-virtual-device CPU mesh
(SURVEY.md §4.4 — the fake-backend tier)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.parallel import mesh as mesh_mod
from jaxmot.parallel import serve, train
from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS
from jaxmot.tracker.api import pad_detections


@pytest.fixture(scope="module")
def ndev():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs multiple (virtual) devices")
    return min(n, 8)


def test_multi_stream_step_sharded(ndev):
    """Per-stream tracking sharded over the mesh must equal running each
    stream independently on one device."""
    cfg = TrackerConfig(max_tracks=16, max_detections=8, frame_height=80,
                        frame_width=100, n_init=1)
    m = mesh_mod.stream_mesh(ndev)
    banks = serve.make_stream_banks(ndev, cfg, m)

    rng = np.random.default_rng(0)
    frames = rng.random((ndev, 80, 100)).astype(np.float32)
    dets = np.zeros((ndev, 8, 5), np.float32)
    valid = np.zeros((ndev, 8), bool)
    per_stream_dets = []
    for s in range(ndev):
        raw = np.concatenate([rng.uniform(20, 80, (2, 2)),
                              rng.uniform(8, 16, (2, 2)),
                              np.ones((2, 1))], 1).astype(np.float32)
        per_stream_dets.append(raw)
        dets[s], valid[s] = pad_detections(raw, 8)

    sh = NamedSharding(m, P("stream"))
    banks2, outs = serve.multi_stream_step(
        banks,
        jax.device_put(jnp.asarray(frames), sh),
        jax.device_put(jnp.asarray(dets), sh),
        jax.device_put(jnp.asarray(valid), sh), cfg)

    # Singleton reference runs.
    from jaxmot.tracker import bank as bank_mod, step as step_mod
    for s in range(ndev):
        b0 = bank_mod.empty_bank(cfg)
        _, ref = step_mod.step(b0, jnp.asarray(frames[s]),
                               jnp.asarray(dets[s]), jnp.asarray(valid[s]),
                               cfg)
        np.testing.assert_allclose(np.asarray(outs.boxes[s]),
                                   np.asarray(ref.boxes), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(np.asarray(outs.ids[s]),
                                      np.asarray(ref.ids))


def test_multi_stream_sequence(ndev):
    # use_kcf=False: frames are random noise here (sharding test, not a
    # correlation test) — KCF refinement on noise drags boxes off the gate.
    cfg = TrackerConfig(max_tracks=8, max_detections=4, frame_height=64,
                        frame_width=64, n_init=1,
                        use_kcf=False)
    m = mesh_mod.stream_mesh(ndev)
    banks = serve.make_stream_banks(ndev, cfg, m)
    rng = np.random.default_rng(1)
    frames = rng.random((ndev, 5, 64, 64)).astype(np.float32)
    dets = np.tile(np.asarray([[32, 32, 12, 12, 1.0]], np.float32),
                   (ndev, 5, 4, 1))
    valid = np.zeros((ndev, 5, 4), bool)
    valid[:, :, 0] = True
    sh = NamedSharding(m, P("stream"))
    banks, outs = serve.multi_stream_sequence(
        banks, jax.device_put(jnp.asarray(frames), sh),
        jax.device_put(jnp.asarray(dets), sh),
        jax.device_put(jnp.asarray(valid), sh), cfg)
    assert np.asarray(outs.n_alive).shape == (ndev, 5)
    assert (np.asarray(outs.n_alive)[:, -1] == 1).all()


def test_dp_train_step_matches_single_device(ndev):
    """DP-sharded detector train step == single-device step on the same
    global batch (the collective correctness check)."""
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    tx = optax.sgd(1e-2)
    rng = np.random.default_rng(2)
    images = rng.random((ndev, 64, 64, 3)).astype(np.float32)
    gt_boxes = rng.uniform(8, 56, (ndev, 1, 4)).astype(np.float32)
    gt_classes = np.zeros((ndev, 1), int)
    gt_valid = np.ones((ndev, 1), bool)
    targets = train.build_targets(spec, gt_boxes, gt_classes, gt_valid)

    state0 = train.init_train_state(spec, tx, seed=0)
    step_fn = train.make_train_step(spec, tx)

    # Single device.
    s1, loss1 = step_fn(state0, jnp.asarray(images),
                        [jnp.asarray(t) for t in targets])

    # Sharded.
    m = mesh_mod.batch_mesh(ndev)
    bsh = NamedSharding(m, P("batch"))
    rep = NamedSharding(m, P())
    s2, loss2 = step_fn(jax.device_put(state0, rep),
                        jax.device_put(jnp.asarray(images), bsh),
                        [jax.device_put(jnp.asarray(t), bsh)
                         for t in targets])
    # rtol: BatchNorm in train mode (r2) reduces batch statistics across
    # the sharded batch axis; GSPMD's all-reduce order differs from the
    # single-device reduction, moving the loss by ~1e-5 rel (benign
    # summation-order numerics — the statistics themselves are global
    # either way under jit+GSPMD).
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-4)
    p1 = jax.tree.leaves(s1[0])[0]
    p2 = jax.tree.leaves(s2[0])[0]
    # atol: the BN batch-stat reductions (r2) shift per-parameter grads
    # by reduction order; Adam normalization amplifies that to ~1e-4 abs
    # on this toy scale.
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-3,
                               atol=3e-4)


def test_shared_detector_batch_equals_dp(ndev):
    """configs[4] collective path: all-gather frames → one batched YOLO →
    scatter dets must equal the zero-collective per-shard DP detector."""
    serve.dryrun_shared_detector(ndev)


def test_multistream_strided_equality(ndev):
    """multi_stream_sequence_strided (grouped cond-free lowering, DP and
    shared-detector modes) must equal multi_stream_sequence fed the same
    detections computed explicitly at stride frames and empty elsewhere."""
    from jaxmot.models.detector import YoloDetector, detect_batch

    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.2)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128)
    m = mesh_mod.stream_mesh(ndev)
    n, stride = 6, 3
    frames = jnp.asarray(np.random.default_rng(5).random(
        (n, ndev, 96, 128)).astype(np.float32))     # time-major [T, S]

    def detect_fn(params, fr):
        return detect_batch(params, fr, spec, (96, 128), 8, 0.45, 0.2)

    # Explicit-detections reference: detect every frame flattened, zero
    # the non-stride frames, feed stream-major to multi_stream_sequence.
    d, v, _ = detect_batch(det.params, frames.reshape(-1, 96, 128), spec,
                           (96, 128), 8, 0.45, 0.2)
    d = np.asarray(d).reshape(n, ndev, 8, 5)
    v = np.asarray(v).reshape(n, ndev, 8)
    mask = (np.arange(n) % stride) == 0
    d = d * mask[:, None, None, None]
    v = v & mask[:, None, None]
    banks0 = serve.make_stream_banks(ndev, cfg, m)
    _, out_ref = serve.multi_stream_sequence(
        banks0, jnp.swapaxes(frames, 0, 1),
        jnp.asarray(np.swapaxes(d, 0, 1)),
        jnp.asarray(np.swapaxes(v, 0, 1)), cfg)

    for mesh in (None, m):
        _, out = serve.multi_stream_sequence_strided(
            det.params, banks0, frames, cfg, detect_fn, stride, mesh=mesh)
        tag = "shared" if mesh is not None else "dp"
        np.testing.assert_array_equal(np.asarray(out.ids),
                                      np.asarray(out_ref.ids), err_msg=tag)
        np.testing.assert_array_equal(np.asarray(out.valid),
                                      np.asarray(out_ref.valid),
                                      err_msg=tag)
        # CNN fusion context differs inside the scan vs standalone —
        # pixel-noise tolerance, ids/validity exact (same contract as
        # tests/test_detector.py::test_strided_detector_equality).
        np.testing.assert_allclose(np.asarray(out.boxes),
                                   np.asarray(out_ref.boxes), atol=0.05,
                                   err_msg=tag)


def test_multistream_strided_class_aware(ndev):
    """Class-aware multistream serving: both detector modes (DP and
    shared all-gather batch) must carry the detector class column and
    equal multi_stream_sequence fed explicit 6-col detections."""
    from jaxmot.models.detector import (YoloDetector, detect_batch,
                                         dets_with_classes)

    spec = YoloSpec("yolov2-tiny", num_classes=3, input_size=64)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.2)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128, class_aware=True)
    m = mesh_mod.stream_mesh(ndev)
    n, stride = 6, 3
    frames = jnp.asarray(np.random.default_rng(7).random(
        (n, ndev, 96, 128)).astype(np.float32))     # time-major [T, S]

    def detect_fn(params, fr):
        return detect_batch(params, fr, spec, (96, 128), 8, 0.45, 0.2)

    d, v, c = detect_batch(det.params, frames.reshape(-1, 96, 128), spec,
                           (96, 128), 8, 0.45, 0.2)
    d6 = np.asarray(dets_with_classes(d, c)).reshape(n, ndev, 8, 6)
    v = np.asarray(v).reshape(n, ndev, 8)
    mask = (np.arange(n) % stride) == 0
    d6 = d6 * mask[:, None, None, None]
    v = v & mask[:, None, None]
    banks0 = serve.make_stream_banks(ndev, cfg, m)
    _, out_ref = serve.multi_stream_sequence(
        banks0, jnp.swapaxes(frames, 0, 1),
        jnp.asarray(np.swapaxes(d6, 0, 1)),
        jnp.asarray(np.swapaxes(v, 0, 1)), cfg)

    for mesh in (None, m):
        _, out = serve.multi_stream_sequence_strided(
            det.params, banks0, frames, cfg, detect_fn, stride, mesh=mesh)
        tag = "shared" if mesh is not None else "dp"
        np.testing.assert_array_equal(np.asarray(out.ids),
                                      np.asarray(out_ref.ids), err_msg=tag)
        np.testing.assert_array_equal(np.asarray(out.cls),
                                      np.asarray(out_ref.cls), err_msg=tag)
        np.testing.assert_allclose(np.asarray(out.boxes),
                                   np.asarray(out_ref.boxes), atol=0.05,
                                   err_msg=tag)
