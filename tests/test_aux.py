"""Aux subsystem tests: supervisor recovery, profiling utils, fault
injection (SURVEY.md §5)."""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.tracker.api import pad_detections
from jaxmot.utils.profiling import DeviceTimer, FpsMeter
from jaxmot.utils.supervisor import StreamSupervisor, output_healthy


def _scene(n_frames=12):
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(4, 120, 160, rng)
    frames, boxes, vis = synthetic.render_sequence(objs, n_frames, 120,
                                                   160, seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(120, 160))
    return frames, dets


def test_supervisor_normal_flow():
    frames, dets = _scene()
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160, n_init=1)
    sup = StreamSupervisor(cfg, snapshot_every=4)
    for f in range(len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert sup.failures == 0
    assert int(out.n_alive) == 4


def test_supervisor_recovers_from_poisoned_state():
    frames, dets = _scene()
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160, n_init=1)
    sup = StreamSupervisor(cfg, snapshot_every=2)
    for f in range(6):
        d, v = pad_detections(dets[f], 8)
        sup.step(frames[f], d, v)
    # Poison the live bank (simulated corruption / device fault).
    import jax
    sup.bank = sup.bank._replace(
        kf_mean=sup.bank.kf_mean.at[:, 0].set(jnp.nan))
    d, v = pad_detections(dets[6], 8)
    out = sup.step(frames[6], d, v)
    assert sup.failures == 1
    assert np.isfinite(np.asarray(out.boxes)).all()
    # Keeps tracking afterwards.
    for f in range(7, len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert int(out.n_alive) >= 4


def test_supervisor_raises_on_first_compile_failure(monkeypatch):
    """A failure to lower/compile the step is a program fault: the first
    call raises instead of entering recovery."""
    from jaxmot.utils import supervisor as sup_mod

    class Broken:
        def lower(self, *a, **k):
            raise RuntimeError("lowering failed")

    frames, dets = _scene(1)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160)
    monkeypatch.setattr(sup_mod.step_mod, "step", Broken())
    sup = StreamSupervisor(cfg)
    d, v = pad_detections(dets[0], 8)
    import pytest
    with pytest.raises(RuntimeError, match="lowering failed"):
        sup.step(frames[0], d, v)
    assert sup.failures == 0


def test_supervisor_recovers_from_runtime_exception(monkeypatch):
    """After the first compile, an exception raised by a step call is a
    runtime fault: counted once, recovered, the stream continues."""
    from jaxmot.tracker import step as step_mod
    from jaxmot.utils import supervisor as sup_mod

    real = step_mod.step
    calls = {"n": 0}

    class Flaky:
        def lower(self, *a, **k):
            return real.lower(*a, **k)

        def __call__(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("transient device fault")
            return real(*a, **k)

    frames, dets = _scene(6)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160, n_init=1)
    monkeypatch.setattr(sup_mod.step_mod, "step", Flaky())
    sup = StreamSupervisor(cfg, snapshot_every=1)
    for f in range(6):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert sup.failures == 1 and sup.last_recovery_frame == 2
    assert int(out.n_alive) == 4


def test_output_healthy_flags_nans():
    frames, dets = _scene(2)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160)
    sup = StreamSupervisor(cfg)
    d, v = pad_detections(dets[0], 8)
    out = sup.step(frames[0], d, v)
    assert output_healthy(out, (120, 160))
    bad = out._replace(boxes=out.boxes.at[0, 0].set(jnp.nan))
    assert not output_healthy(bad, (120, 160))


def test_fault_injection_hooks():
    """detections_from_gt exposes drop/false-positive injection."""
    rng = np.random.default_rng(1)
    objs = synthetic.make_objects(6, 120, 160, rng)
    _, boxes, vis = synthetic.render_sequence(objs, 20, 120, 160, seed=1)
    clean = synthetic.detections_from_gt(boxes, vis, seed=1,
                                         frame_hw=(120, 160))
    faulty = synthetic.detections_from_gt(boxes, vis, seed=1,
                                          drop_prob=0.5, fp_per_frame=2.0,
                                          frame_hw=(120, 160))
    n_clean = sum(len(d) for d in clean)
    n_faulty_tp = sum(len(d) for d in faulty)
    assert n_faulty_tp != n_clean


def test_device_timer_and_fps_meter():
    with DeviceTimer() as t:
        x = jnp.ones((256, 256)) @ jnp.ones((256, 256))
        t.observe(x)
    assert t.elapsed > 0
    m = FpsMeter()
    for _ in range(5):
        m.tick(2)
    assert m.n_frames == 10
    assert m.stats()["frames"] == 10


def test_otb_precision_metric():
    from jaxmot.utils.metrics import otb_precision
    gt = np.array([[100.0, 100, 20, 40]] * 10)
    pred = gt.copy()
    pred[5:, 0] += 30  # half the frames off by 30px
    m = otb_precision(gt, pred, thresholds=(20.0,))
    assert m["precision@20px"] == 0.5
    assert m["mean_center_error"] == 15.0
    assert m["success@0.5"] == 0.5


def test_viz_draw_tracks():
    from jaxmot.utils.viz import draw_tracks
    frame = np.zeros((60, 80), np.float32)
    img = draw_tracks(frame, [(3, (40.0, 30.0, 20.0, 16.0), 0.9)])
    assert img.shape == (60, 80, 3) and img.dtype == np.uint8
    assert img.sum() > 0   # something was drawn


def test_checkpoint_pytree_roundtrip(tmp_path):
    from jaxmot.utils import checkpoint as ckpt
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.config import TrackerConfig

    cfg = TrackerConfig(max_tracks=4, max_detections=4)
    bank = bank_mod.empty_bank(cfg)
    bank = bank._replace(next_id=jnp.int32(7),
                         kf_mean=bank.kf_mean + 3.0)
    p = str(tmp_path / "bank.npz")
    ckpt.save_pytree(p, bank)
    restored = ckpt.load_pytree(p, bank_mod.empty_bank(cfg))
    import jax
    for a, b in zip(jax.tree.leaves(bank), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_orbax_roundtrip(tmp_path):
    import pytest
    from jaxmot.utils import checkpoint as ckpt
    if not ckpt._has_orbax():
        pytest.skip("orbax not available")
    tree = {"a": jnp.arange(6.0).reshape(2, 3), "b": jnp.int32(3)}
    p = str(tmp_path / "ck")
    ckpt.save_pytree(p, tree)
    restored = ckpt.load_pytree(p, tree)
    np.testing.assert_array_equal(np.asarray(restored["a"]),
                                  np.asarray(tree["a"]))
