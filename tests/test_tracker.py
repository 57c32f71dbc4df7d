"""MOT integration tests (SURVEY.md §4.3/4.5): the fused step vs the
NumPy SORT oracle, KCF coasting through detector dropouts, determinism,
checkpoint/resume, and capacity overflow."""

import numpy as np
import jax

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.tracker import scan
from jaxmot.tracker.api import MultiTracker
from jaxmot.utils import metrics

import oracles


def _make_scene(n_obj=12, n_frames=40, seed=0, hw=(240, 320), **det_kw):
    rng = np.random.default_rng(seed)
    objs = synthetic.make_objects(n_obj, hw[0], hw[1], rng, max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, hw[0], hw[1], seed=seed)
    dets = synthetic.detections_from_gt(boxes, vis, seed=seed,
                                        frame_hw=hw, **det_kw)
    gt_frames = []
    for f in range(n_frames):
        idx = np.where(vis[f])[0]
        gt_frames.append((idx, boxes[f, idx]))
    return frames, dets, gt_frames


def _run_ours(frames, dets, cfg):
    mt = MultiTracker(cfg)
    hyp = []
    for f, frame in enumerate(frames):
        if f == 0:
            tracks = mt.init(frame, dets[f])
        else:
            tracks = mt.update(frame, dets[f])
        hyp.append((np.array([t[0] for t in tracks]),
                    np.array([t[1] for t in tracks]).reshape(-1, 4)))
    return hyp, mt


def _run_oracle(dets, cfg):
    so = oracles.SORTOracle(iou_gate=cfg.iou_gate, n_init=cfg.n_init,
                            max_age=cfg.max_age,
                            max_age_tentative=cfg.max_age_tentative)
    hyp = []
    for d in dets:
        tracks = so.step(d)
        hyp.append((np.array([t[0] for t in tracks]),
                    np.array([t[1] for t in tracks]).reshape(-1, 4)))
    return hyp


def test_sort_mode_matches_oracle_mota():
    """Kalman+auction IoU-only tracker vs NumPy SORT oracle — the
    detector-free config (BASELINE configs[0]); MOTA delta <= 0.01."""
    frames, dets, gt = _make_scene()
    cfg = TrackerConfig(use_kcf=False, frame_height=240, frame_width=320)
    hyp_ours, _ = _run_ours(frames, dets, cfg)
    hyp_oracle = _run_oracle(dets, cfg)
    m_ours = metrics.clear_mot(gt, hyp_ours)
    m_oracle = metrics.clear_mot(gt, hyp_oracle)
    assert m_oracle["mota"] > 0.75, m_oracle     # sanity on the oracle
    assert abs(m_ours["mota"] - m_oracle["mota"]) <= 0.01, (
        m_ours["mota"], m_oracle["mota"])
    assert m_ours["idsw"] <= m_oracle["idsw"] + 2


def test_full_pipeline_tracks_well():
    frames, dets, gt = _make_scene()
    cfg = TrackerConfig(frame_height=240, frame_width=320)
    hyp, mt = _run_ours(frames, dets, cfg)
    m = metrics.clear_mot(gt, hyp)
    assert m["mota"] > 0.75, m
    assert m["idf1"] > 0.7, m
    c = mt.counters()
    assert c["alive"] >= 10


def test_kcf_coasts_through_detector_outage():
    """Detector outage across direction changes: constant-velocity
    coasting (SORT) diverges after the objects bounce, while the KCF
    correlation pseudo-measurements keep following them — the reason the
    reference pairs KCF with the Kalman/Hungarian layer."""
    rng = np.random.default_rng(7)
    objs = [
        synthetic.SyntheticObject(cx=40, cy=60, w=26, h=26, vx=-4.0, vy=1.0),
        synthetic.SyntheticObject(cx=280, cy=180, w=28, h=24, vx=4.0, vy=-1.0),
        synthetic.SyntheticObject(cx=160, cy=30, w=24, h=28, vx=1.0, vy=-4.0),
    ]
    n_frames = 45
    frames, boxes, vis = synthetic.render_sequence(
        objs, n_frames, 240, 320, seed=7)
    dets = synthetic.detections_from_gt(boxes, vis, seed=7,
                                        frame_hw=(240, 320))
    for f in range(12, 32):                      # detector outage window
        dets[f] = np.zeros((0, 5), np.float32)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]

    kw = dict(frame_height=240, frame_width=320, n_init=2)
    cfg_kcf = TrackerConfig(use_kcf=True, min_psr=0.15, **kw)
    cfg_sort = TrackerConfig(use_kcf=False, **kw)
    m_kcf = metrics.clear_mot(gt, _run_ours(frames, dets, cfg_kcf)[0])
    m_sort = metrics.clear_mot(gt, _run_ours(frames, dets, cfg_sort)[0])
    assert m_kcf["mota"] > m_sort["mota"] + 0.1, (
        m_kcf["mota"], m_sort["mota"])
    assert m_kcf["idsw"] <= m_sort["idsw"], (m_kcf, m_sort)


def test_golden_determinism():
    """Same inputs twice → bit-identical outputs (SURVEY.md §4.5)."""
    frames, dets, _ = _make_scene(n_obj=5, n_frames=10, seed=4)
    cfg = TrackerConfig(frame_height=240, frame_width=320)
    out1, mt1 = _run_ours(frames, dets, cfg)
    out2, mt2 = _run_ours(frames, dets, cfg)
    for (i1, b1), (i2, b2) in zip(out1, out2):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(b1, b2)
    for a, b in zip(jax.tree.leaves(mt1.bank), jax.tree.leaves(mt2.bank)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume():
    """Snapshot mid-sequence and resume — must equal the uninterrupted
    run exactly (tracker state is one pytree; SURVEY.md §5)."""
    frames, dets, _ = _make_scene(n_obj=5, n_frames=12, seed=5)
    cfg = TrackerConfig(frame_height=240, frame_width=320)

    mt = MultiTracker(cfg)
    ref_out = [mt.init(frames[0], dets[0])]
    snap = None
    for f in range(1, 12):
        if f == 6:
            snap = mt.save_state()
        ref_out.append(mt.update(frames[f], dets[f]))

    mt2 = MultiTracker(cfg)
    mt2.load_state(snap)
    for f in range(6, 12):
        got = mt2.update(frames[f], dets[f])
        assert got == ref_out[f], f


def test_capacity_overflow_is_graceful():
    """More detections than slots: no crash, no duplicate IDs."""
    frames, dets, _ = _make_scene(n_obj=6, n_frames=6, seed=6)
    cfg = TrackerConfig(max_tracks=4, max_detections=8, n_init=1,
                        frame_height=240, frame_width=320)
    mt = MultiTracker(cfg)
    mt.init(frames[0], dets[0])
    for f in range(1, 6):
        tracks = mt.update(frames[f], dets[f])
        ids = [t[0] for t in tracks]
        assert len(ids) == len(set(ids))
        assert len(ids) <= 4


def test_scale_adaptive_kcf_in_mot_step():
    """cfg.kcf.scale_step > 1 exercises the scale branch of the fused
    step: an object whose size changes during a detector outage keeps a
    higher IoU with scale search than without."""
    from jaxmot.config import KCFConfig
    import numpy as np

    # Growing object: render at increasing size by scaling the fixture.
    n = 36
    frames = np.zeros((n, 240, 320), np.float32)
    gt = np.zeros((n, 1, 4), np.float32)
    rng = np.random.default_rng(0)
    tex = rng.random((64, 64)).astype(np.float32)
    import cv2
    for f in range(n):
        # Constant size while detections exist (KF size-velocity learns
        # zero), then growth begins — only the KCF scale search can
        # follow it.
        s = 24.0 if f < 6 else 24 + (f - 6) * 1.2
        img = rng.random((240, 320)).astype(np.float32) * 0.1
        patch = cv2.resize(tex, (int(s), int(s)))
        cx, cy = 160 + f * 1.5, 120
        y0, x0 = int(cy - s / 2), int(cx - s / 2)
        img[y0:y0 + int(s), x0:x0 + int(s)] = patch
        frames[f] = img
        gt[f, 0] = (cx, cy, s, s)
    dets = [np.concatenate([gt[f], np.ones((1, 1), np.float32)], 1)
            if f < 6 else np.zeros((0, 5), np.float32) for f in range(n)]

    def run(scale_step):
        cfg = TrackerConfig(
            frame_height=240, frame_width=320, n_init=2, min_psr=0.1,
            kcf=KCFConfig(scale_step=scale_step))
        hyp, _ = _run_ours(frames, dets, cfg)
        ious = []
        for f in range(10, n):
            ids, boxes = hyp[f]
            if len(ids) == 0:
                ious.append(0.0)
                continue
            import oracles
            ious.append(max(oracles.iou_xywh(b, gt[f, 0]) for b in boxes))
        return np.mean(ious)

    iou_scale = run(1.05)
    iou_fixed = run(1.0)
    assert iou_scale > iou_fixed + 0.05, (iou_scale, iou_fixed)


def test_scale_batched_matches_sequential():
    """The [3T]-batched scale search (scales folded into the track axis)
    must reproduce the sequential per-scale formulation it replaced:
    same responses, same peak/scale decisions."""
    import jax.numpy as jnp
    from jaxmot.config import KCFConfig
    from jaxmot.ops import features as feat_ops
    from jaxmot.ops import kcf as kcf_ops
    from jaxmot.ops import patch as patch_ops

    for feature_type, cell in (("gray", 1), ("hog", 4)):
        cfg = KCFConfig(scale_step=1.05, feature_type=feature_type,
                        cell_size=cell)
        rng = np.random.default_rng(3)
        t = 5
        frame = jnp.asarray(rng.random((240, 320)).astype(np.float32))
        boxes = jnp.asarray(np.stack([
            rng.uniform(60, 260, t), rng.uniform(60, 180, t),
            rng.uniform(20, 48, t), rng.uniform(20, 48, t)],
            axis=1).astype(np.float32))

        def feats_at(bxs, scales=None):
            p = patch_ops.extract_patches(frame, bxs, cfg.padding,
                                          cfg.template_size, scales)
            return feat_ops.extract_features(p, cfg)

        yf = kcf_ops.make_yf(cfg.feature_size, cfg.padding,
                             cfg.output_sigma_factor)
        model = kcf_ops.train(feats_at(boxes), yf, cfg.kernel_sigma,
                              cfg.lambda_)

        # Sequential reference formulation (the pre-r3 shape).
        scale_list = (1.0 / cfg.scale_step, 1.0, cfg.scale_step)
        seq = jnp.stack([
            kcf_ops.detect(model, feats_at(
                boxes, jnp.full((t,), sc, jnp.float32)), cfg.kernel_sigma)
            for sc in scale_list])                        # [3, T, S, S]

        # Batched formulation (what tracker/step.py now runs).
        scale_vals = jnp.asarray(scale_list, jnp.float32)
        f3 = feats_at(jnp.tile(boxes, (3, 1)),
                      jnp.repeat(scale_vals, t))
        f3 = f3.reshape((3, t) + f3.shape[1:])
        bat = kcf_ops.detect(model, f3, cfg.kernel_sigma)

        np.testing.assert_allclose(np.asarray(bat), np.asarray(seq),
                                   rtol=0, atol=2e-5)

        # Peak/scale selection agrees exactly on the (identical) maps.
        s = cfg.feature_size
        dy_s, dx_s, pk_s = kcf_ops.peak_displacement(
            seq.reshape(3 * t, s, s))
        dy_b, dx_b, pk_b = kcf_ops.peak_displacement(
            bat.reshape(3 * t, s, s))
        np.testing.assert_allclose(np.asarray(pk_b), np.asarray(pk_s),
                                   rtol=0, atol=2e-5)
        np.testing.assert_array_equal(
            np.asarray(dy_b == dy_s).all(), True)


def test_functional_api_aliases():
    """mot_init / mot_update — the reference's public names."""
    import jax.numpy as jnp
    from jaxmot import tracker as T

    frames, dets, _ = _make_scene(n_obj=3, n_frames=3, seed=9)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=240,
                        frame_width=320, n_init=1)
    from jaxmot.tracker.api import pad_detections
    d, v = pad_detections(dets[0], 8)
    bank, out = T.mot_init(jnp.asarray(frames[0]), jnp.asarray(d),
                           jnp.asarray(v), cfg)
    d, v = pad_detections(dets[1], 8)
    bank, out = T.mot_update(bank, jnp.asarray(frames[1]), jnp.asarray(d),
                             jnp.asarray(v), cfg)
    assert int(out.n_alive) == 3


def test_init_with_no_detections_and_empty_updates():
    """Degenerate flows: empty init, empty updates, then late arrivals."""
    frames, dets, _ = _make_scene(n_obj=3, n_frames=6, seed=10)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=240,
                        frame_width=320, n_init=1)
    mt = MultiTracker(cfg)
    assert mt.init(frames[0], np.zeros((0, 5), np.float32)) == []
    assert mt.update(frames[1]) == []
    tracks = mt.update(frames[2], dets[2])
    assert tracks == []                    # births start tentative
    tracks = mt.update(frames[3], dets[3])
    assert len(tracks) == 3                # confirmed on the next match


def test_scan_unroll_parity():
    """cfg.scan_unroll must be a pure scheduling knob: identical outputs
    (bit-exact on CPU) for unroll 1/2/3, including a non-divisible
    sequence length and the masked frame_valid path."""
    import jax.numpy as jnp
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker.api import pad_detections

    frames, dets, _ = _make_scene(n_obj=6, n_frames=11, seed=3)
    base = dict(max_tracks=8, max_detections=8, frame_height=240,
                frame_width=320)
    n = len(frames)
    d = np.zeros((n, 8, 5), np.float32)
    v = np.zeros((n, 8), bool)
    for f in range(n):
        d[f], v[f] = pad_detections(dets[f], 8)
    fj, dj, vj = jnp.asarray(frames), jnp.asarray(d), jnp.asarray(v)
    fv = jnp.asarray(np.arange(n) < n - 2)       # 2 masked tail frames

    ref = None
    for unroll in (1, 2, 3):
        cfg = TrackerConfig(scan_unroll=unroll, **base)
        bank, out = scan.run_sequence(bank_mod.empty_bank(cfg), fj, dj,
                                      vj, cfg)
        bankm, outm = scan.run_sequence(bank_mod.empty_bank(cfg), fj, dj,
                                        vj, cfg, frame_valid=fv)
        got = jax.tree.map(np.asarray, (bank, out, bankm, outm))
        if ref is None:
            ref = got
        else:
            jax.tree.map(np.testing.assert_array_equal, ref, got)


def test_output_max_tsu_gates_coasting_tracks():
    """output_max_tsu=0 emits only tracks matched THIS frame (SORT
    convention); coasting confirmed tracks are suppressed from output but
    stay alive for re-association."""
    frames, dets, _ = _make_scene(n_obj=4, n_frames=14, seed=11)
    for f in range(6, 10):
        dets[f] = np.zeros((0, 5), np.float32)
    cfg = TrackerConfig(frame_height=240, frame_width=320, n_init=1,
                        use_kcf=False, output_max_tsu=0)
    mt = MultiTracker(cfg)
    mt.init(frames[0], dets[0])
    for f in range(1, 6):
        tracks = mt.update(frames[f], dets[f])
    assert len(tracks) == 4
    tracks = mt.update(frames[6], dets[6])     # outage: nothing emitted
    assert tracks == []
    for f in range(7, 14):
        tracks = mt.update(frames[f], dets[f])
    assert len(tracks) == 4                    # same tracks re-emitted


def test_long_sequence_stability():
    """500 frames with churn (objects appearing/disappearing): slot
    recycling keeps working, IDs stay unique and monotone, state stays
    finite — the soak test for the fixed-capacity bank."""
    import jax.numpy as jnp
    from jaxmot.tracker import scan

    rng = np.random.default_rng(12)
    objs = synthetic.make_objects(10, 160, 240, rng, max_speed=2.5,
                                  lifespan=(0, 200))
    for i, o in enumerate(objs):
        o.vanish = o.appear + 150 + 20 * (i % 4)   # staggered churn
    frames, boxes, vis = synthetic.render_sequence(objs, 500, 160, 240,
                                                   seed=12)
    dets = synthetic.detections_from_gt(boxes, vis, seed=12,
                                        frame_hw=(160, 240))
    cfg = TrackerConfig(max_tracks=16, max_detections=16, n_init=2,
                        max_age=10, frame_height=160, frame_width=240,
                        )
    bank, tracks, out = scan.track_sequence(frames, dets, cfg, chunk=100)
    assert np.isfinite(np.asarray(bank.kf_mean)).all()
    assert np.isfinite(out.boxes[out.valid]).all()
    # IDs unique within every frame; next_id monotone and bounded by the
    # number of real birth events (no runaway ID churn).
    for f in range(500):
        ids = out.ids[f][out.valid[f]]
        assert len(set(ids.tolist())) == len(ids)
    assert int(bank.next_id) < 300, int(bank.next_id)
    # Full lifecycle arc: busy mid-sequence, graceful wind-down to an
    # empty bank after every object has left the scene.
    assert int(out.n_alive[150]) >= 6
    assert int(out.n_alive[-1]) == 0
    assert (np.asarray(bank.state) == 0).all()


def test_default_config_survives_occlusion_window():
    """The SHIPPED defaults (psr-gated KCF confidence, appearance blend)
    must keep identity through a real occlusion: the object disappears for
    10 frames (no pixels, no detections) while moving, then reappears.
    With the ungated r1 default the KCF correlated on background during
    the window and dragged the Kalman state off (tools/sweep_defaults.py:
    MOTA 0.72 -> 0.79, idsw 6 -> 2.7 across the sweep fixture)."""
    from jaxmot.tracker import scan

    rng = np.random.default_rng(7)
    objs = synthetic.make_objects(6, 240, 320, rng, max_speed=2.5)
    objs[0].occlude = (15, 25)
    objs[3].occlude = (18, 28)
    frames, boxes, vis = synthetic.render_sequence(objs, 45, 240, 320,
                                                   seed=7)
    dets = synthetic.detections_from_gt(boxes, vis, seed=7,
                                        frame_hw=(240, 320))
    cfg = TrackerConfig(max_tracks=16, max_detections=16,
                        frame_height=240, frame_width=320)
    assert cfg.confidence_mode == "psr"
    assert cfg.confidence_threshold > 0  # per-mode resolved default
    _, tracks, _ = scan.track_sequence(frames, dets, cfg)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(45)]
    hyp = [(np.asarray([t[0] for t in tr]),
            np.asarray([t[1] for t in tr]).reshape(-1, 4))
           for tr in tracks]
    m = metrics.clear_mot(gt, hyp)
    assert m["mota"] > 0.7, m
    assert m["idsw"] <= 2, m


def test_adversarial_inputs_no_crash():
    """Public-API fuzz: degenerate/hostile inputs must not crash or poison
    the bank — zero-size and negative boxes, detections outside the frame,
    NaN scores, empty updates, all-black and all-white frames."""
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=64,
                        frame_width=96, n_init=1)
    mt = MultiTracker(cfg)
    mt.init(np.zeros((64, 96), np.float32),
            np.asarray([[20, 20, 10, 10, 1.0]], np.float32))
    hostile = [
        (np.ones((64, 96), np.float32),
         np.asarray([[5, 5, 0.0, -3.0, 1.0]], np.float32)),   # degenerate wh
        (np.zeros((64, 96), np.float32),
         np.asarray([[500, -40, 10, 10, 1.0]], np.float32)),  # off-frame
        (np.random.default_rng(0).random((64, 96)).astype(np.float32),
         np.asarray([[30, 30, 10, 10, np.nan]], np.float32)),  # NaN score
        (np.full((64, 96), 0.5, np.float32), None),            # no dets
        (np.zeros((64, 96), np.float32),
         np.zeros((0, 5), np.float32)),                        # empty dets
    ]
    for frame, dets in hostile:
        tracks = mt.update(frame, dets)
        for tid, box, score in tracks:
            assert all(np.isfinite(v) for v in box), (tid, box)
    # The bank itself must stay finite (NaN scores are quarantined by the
    # det_score_min comparison returning False for NaN).
    assert np.isfinite(np.asarray(mt.bank.kf_mean)).all()
    assert np.isfinite(np.asarray(mt.bank.kcf.alphaf.re)).all()


def test_chunked_remainder_matches_unchunked():
    """The masked tail-chunk path (padding the remainder to the chunk
    length so no second XLA shape is compiled) must produce identical
    tracks AND an identical final bank to the unchunked run."""
    rng = np.random.default_rng(13)
    objs = synthetic.make_objects(6, 120, 160, rng, min_size=12,
                                  max_size=24, max_speed=2.0)
    frames, gt, vis = synthetic.render_sequence(objs, 11, 120, 160,
                                                seed=3, noise=0.01)
    dets = synthetic.detections_from_gt(gt, vis, seed=3,
                                        frame_hw=(120, 160))
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                        frame_width=160)
    b1, t1, s1 = scan.track_sequence(frames, dets, cfg)            # one shot
    b2, t2, s2 = scan.track_sequence(frames, dets, cfg, chunk=4)   # 4,4,3
    assert t1 == t2
    for a, b in zip(jax.tree.leaves(b1), jax.tree.leaves(b2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_update_async_matches_update():
    """update_async + unpack == update, frame for frame (the async path
    must only skip the fetch, not change the math)."""
    frames, dets, _ = _make_scene(n_obj=4, n_frames=6, seed=11)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=240,
                        frame_width=320, n_init=1)
    mt_sync = MultiTracker(cfg)
    mt_async = MultiTracker(cfg)
    got_sync = [mt_sync.init(frames[0], dets[0])]
    mt_async.init(frames[0], dets[0])
    pending = []
    for f in range(1, 6):
        got_sync.append(mt_sync.update(frames[f], dets[f]))
        pending.append(mt_async.update_async(frames[f], dets[f]))
    got_async = [mt_async.unpack(o) for o in pending]
    assert got_sync[1:] == got_async


def test_config_axes_cross_product_no_crash():
    """Every combination of the association config axes (class_aware x
    assoc_box) must track the standard fixture without crashing, with
    finite outputs and a sane id count.  Exact per-axis semantics are
    pinned in their own tests; this is the cheap cross-product smoke
    that catches axis interactions."""
    rng = np.random.default_rng(21)
    objs = synthetic.make_objects(4, 96, 128, rng, min_size=12,
                                  max_size=20, max_speed=2.0,
                                  n_classes=2)
    classes = np.asarray([o.cls for o in objs], np.int64)
    frames, gt, vis = synthetic.render_sequence(objs, 6, 96, 128, seed=5)
    dets6 = synthetic.detections_from_gt(gt, vis, seed=5,
                                         frame_hw=(96, 128),
                                         classes=classes)
    for class_aware in (False, True):
        for assoc_box in ("refined", "predicted", "best"):
            cfg = TrackerConfig(
                max_tracks=8, max_detections=8, frame_height=96,
                frame_width=128, n_init=1, class_aware=class_aware,
                assoc_box=assoc_box)
            _, tracks, outs = scan.track_sequence(frames, dets6, cfg)
            assert np.isfinite(np.asarray(outs.boxes)).all(), (
                class_aware, assoc_box)
            n_ids = len({tid for tr in tracks for tid, _, _ in tr})
            assert 2 <= n_ids <= 8, (class_aware, assoc_box, n_ids)
