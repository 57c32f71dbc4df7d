"""Appearance-blended association + fused detect-then-track serving +
sanitizer-mode coverage."""

import numpy as np
import jax
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.tracker.api import MultiTracker, pad_detections
from jaxmot.utils import metrics


def _scene(**kw):
    rng = np.random.default_rng(kw.pop("seed", 0))
    objs = synthetic.make_objects(kw.pop("n_obj", 10), 240, 320, rng,
                                  max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, kw.pop("n", 30),
                                                   240, 320, seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(240, 320), **kw)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(len(frames))]
    return frames, dets, gt


def _mota(frames, dets, gt, cfg):
    mt = MultiTracker(cfg)
    hyp = []
    for f in range(len(frames)):
        tr = mt.init(frames[f], dets[f]) if f == 0 else \
            mt.update(frames[f], dets[f])
        hyp.append((np.array([t[0] for t in tr]),
                    np.array([t[1] for t in tr]).reshape(-1, 4)))
    return metrics.clear_mot(gt, hyp)


def test_appearance_term_works():
    """appearance_weight > 0 exercises the response-sampling cost path and
    must not degrade tracking on the clean scene."""
    frames, dets, gt = _scene()
    base = dict(frame_height=240, frame_width=320)
    m0 = _mota(frames, dets, gt, TrackerConfig(**base))
    m1 = _mota(frames, dets, gt,
               TrackerConfig(appearance_weight=0.3, **base))
    assert m1["mota"] >= m0["mota"] - 0.02, (m1["mota"], m0["mota"])
    assert m1["mota"] > 0.8


def test_detect_then_track_serving():
    """parallel.serve.detect_then_track_step with a real (random-weight)
    YOLO detector over multiple streams."""
    from jaxmot.parallel import mesh as mesh_mod, serve
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec, YOLOV2_TINY_ANCHORS
    import functools

    ndev = min(len(jax.devices()), 4)
    spec = YoloSpec("yolov2-tiny", num_classes=1, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.0)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=64,
                        frame_width=64, n_init=1)
    m = mesh_mod.stream_mesh(ndev)
    banks = serve.make_stream_banks(ndev, cfg, m)
    frames = jnp.asarray(
        np.random.default_rng(0).random((ndev, 64, 64)).astype(np.float32))

    detect_fn = functools.partial(detect_batch, spec=spec, frame_hw=(64, 64),
                                  max_out=8, score_thr=0.0)
    banks, out = serve.detect_then_track_step(
        det.params, banks, frames, cfg,
        lambda p, f: detect_fn(p, f))
    assert np.isfinite(np.asarray(out.boxes)).all()
    assert np.asarray(out.n_alive).shape == (ndev,)


def test_sanitizer_modes():
    """SURVEY.md §5 'race detection / sanitizers': the parity tier must
    run under jax_debug_nans and with jit disabled."""
    frames, dets, gt = _scene(n=4, n_obj=3)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=240,
                        frame_width=320, n_init=1)
    try:
        jax.config.update("jax_debug_nans", True)
        mt = MultiTracker(cfg)
        mt.init(frames[0], dets[0])
        mt.update(frames[1], dets[1])
    finally:
        jax.config.update("jax_debug_nans", False)

    with jax.disable_jit():
        mt = MultiTracker(cfg)
        mt.init(frames[0], dets[0])
        out = mt.update(frames[1], dets[1])
    assert len(out) >= 0
