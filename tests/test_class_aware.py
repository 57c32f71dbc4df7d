"""Class-aware association (cfg.class_aware): detections may carry a
detector class id as a 6th column; a track then only matches detections of
its birth class (cross-class pairs are gated infeasible exactly like a
failed IoU gate).

The reference pipeline tracks a single detector class (SURVEY.md §2 row
"detector (YOLO)" — the darkflow wrapper filters one class before the
tracker sees detections), so class_aware defaults OFF and 5-column
detections keep their exact traces; these tests pin the opt-in behavior.
"""

import numpy as np
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.models.detector import dets_with_classes
from jaxmot.tracker import step as step_mod
from jaxmot.tracker.api import MultiTracker, pad_detections


def _cfg(**kw):
    kw.setdefault("max_tracks", 8)
    kw.setdefault("max_detections", 8)
    kw.setdefault("frame_height", 120)
    kw.setdefault("frame_width", 160)
    kw.setdefault("use_kcf", False)
    kw.setdefault("n_init", 1)
    return TrackerConfig(**kw)


def _pad6(rows, cap):
    return pad_detections(np.asarray(rows, np.float32), cap)


def test_cross_class_pair_is_gated():
    """A det at the track's exact location but of another class must not
    match; it births a new track instead (and the track coasts)."""
    frame = np.zeros((120, 160), np.float32)
    for aware, expect_match in [(True, False), (False, True)]:
        cfg = _cfg(class_aware=aware)
        dets, valid = _pad6([[50, 60, 20, 20, 1.0, 0.0]],
                            cfg.max_detections)
        bank, _ = step_mod.init(jnp.asarray(frame), jnp.asarray(dets),
                                jnp.asarray(valid), cfg)
        # Same box, class 1 now.
        dets2, valid2 = _pad6([[50, 60, 20, 20, 1.0, 1.0]],
                              cfg.max_detections)
        bank, out = step_mod.step(bank, jnp.asarray(frame),
                                  jnp.asarray(dets2), jnp.asarray(valid2),
                                  cfg)
        matched = int(np.asarray(out.matched_det)[0])
        if expect_match:
            assert matched == 0
        else:
            assert matched == -1
            # The class-1 det birthed a fresh track carrying its class.
            cls = np.asarray(out.cls)
            ids = np.asarray(out.ids)
            assert set(cls[ids >= 0]) == {0, 1}


def test_birth_records_class_and_output_surfaces_it():
    cfg = _cfg(class_aware=True)
    frame = np.zeros((120, 160), np.float32)
    dets, valid = _pad6([[30, 30, 16, 16, 0.9, 2.0],
                         [100, 80, 16, 16, 0.8, 5.0]], cfg.max_detections)
    bank, out = step_mod.init(jnp.asarray(frame), jnp.asarray(dets),
                              jnp.asarray(valid), cfg)
    cls = np.asarray(out.cls)
    ids = np.asarray(out.ids)
    assert sorted(cls[ids >= 0].tolist()) == [2, 5]
    assert np.all(cls[ids < 0] == -1)
    assert np.array_equal(np.asarray(bank.cls), cls)


def test_five_column_dets_under_class_aware_are_single_class():
    """[D, 5] detections with class_aware=True behave as all class 0 —
    the gate is trivially true (documented single-class semantics)."""
    cfg = _cfg(class_aware=True)
    frame = np.zeros((120, 160), np.float32)
    dets, valid = pad_detections(
        np.asarray([[50, 60, 20, 20, 1.0]], np.float32),
        cfg.max_detections)
    assert dets.shape[1] == 5
    bank, _ = step_mod.init(jnp.asarray(frame), jnp.asarray(dets),
                            jnp.asarray(valid), cfg)
    bank, out = step_mod.step(bank, jnp.asarray(frame), jnp.asarray(dets),
                              jnp.asarray(valid), cfg)
    assert int(np.asarray(out.matched_det)[0]) == 0
    assert int(np.asarray(out.cls)[0]) == 0


def test_pad_detections_keeps_class_column():
    out6, valid = _pad6([[1, 2, 3, 4, 0.5, 7.0]], 4)
    assert out6.shape == (4, 6)
    assert out6[0, 5] == 7.0
    out5, _ = pad_detections(np.zeros((2, 5), np.float32), 4)
    assert out5.shape == (4, 5)          # 5-col callers: unchanged trace
    out4, _ = pad_detections(np.zeros((2, 4), np.float32), 4)
    assert out4.shape == (4, 5)


def test_dets_with_classes_helper():
    dets = jnp.ones((3, 4, 5), jnp.float32)
    classes = jnp.asarray([[0, 1, 2, 3]] * 3, jnp.int32)
    out = dets_with_classes(dets, classes)
    assert out.shape == (3, 4, 6)
    np.testing.assert_array_equal(np.asarray(out[..., 5]),
                                  np.asarray(classes, np.float32))


def test_crossing_targets_keep_class_consistent_ids():
    """Two equal-size targets of different classes crossing paths: with
    class_aware the id↔class pairing must survive the crossing frame by
    construction (cross-class matches are infeasible)."""
    cfg = _cfg(class_aware=True, max_age=3)
    mt = MultiTracker(cfg)
    frame = np.zeros((120, 160), np.float32)

    def frame_dets(t):
        xa = 30.0 + 5.0 * t           # class 0 moving right
        xb = 130.0 - 5.0 * t          # class 1 moving left
        return np.asarray([[xa, 60, 18, 18, 1.0, 0.0],
                           [xb, 60, 18, 18, 1.0, 1.0]], np.float32)

    mt.init(frame, frame_dets(0))
    mt.update(frame, frame_dets(1))   # births confirm on first match
    id_by_cls = {}
    o = mt.last_output
    for i in np.where(np.asarray(o.valid))[0]:
        id_by_cls[int(np.asarray(o.cls)[i])] = int(np.asarray(o.ids)[i])
    assert len(id_by_cls) == 2
    for t in range(2, 21):            # they meet at t = 10 exactly
        mt.update(frame, frame_dets(t))
        o = mt.last_output
        ids = np.asarray(o.ids)
        cls = np.asarray(o.cls)
        for i in np.where(np.asarray(o.valid))[0]:
            assert id_by_cls[int(cls[i])] == int(ids[i]), (
                f"id/class pairing broke at t={t}")


def test_strided_detector_class_aware():
    """The strided lowerings carry the detector class column when
    cfg.class_aware: both the grouped (cond-free) and per-frame-cond
    forms must equal run_sequence fed the explicit 6-column detections,
    and the batched chunked-serving form must match the streaming one."""
    from jaxmot.models.detector import YoloDetector, detect_batch
    from jaxmot.models.yolo import YoloSpec
    from jaxmot.tracker import bank as bank_mod
    from jaxmot.tracker import scan

    spec = YoloSpec("yolov2-tiny", num_classes=3, input_size=64)
    det = YoloDetector.random_init(spec, max_out=8, score_thr=0.2)
    cfg = _cfg(class_aware=True, frame_height=96, frame_width=128)
    rng = np.random.default_rng(5)
    frames7 = jnp.asarray(rng.random((7, 96, 128)).astype(np.float32))
    stride = 3
    for n in (6, 7):              # grouped lowering / lax.cond lowering
        frames = frames7[:n]
        bank0 = bank_mod.empty_bank(cfg)
        _, out_strided = scan.run_sequence_strided_detector(
            bank0, frames, det.params, cfg, spec, stride, score_thr=0.2)

        d, v, c = detect_batch(det.params, frames, spec, (96, 128), 8,
                               0.45, 0.2)
        d6 = np.asarray(dets_with_classes(d, c))
        mask = (np.arange(n) % stride) == 0
        d6 = d6 * mask[:, None, None]
        v = np.asarray(v) & mask[:, None]
        _, out_ref = scan.run_sequence(bank0, frames, jnp.asarray(d6),
                                       jnp.asarray(v), cfg)
        np.testing.assert_array_equal(np.asarray(out_strided.ids),
                                      np.asarray(out_ref.ids))
        np.testing.assert_array_equal(np.asarray(out_strided.cls),
                                      np.asarray(out_ref.cls))
        np.testing.assert_allclose(np.asarray(out_strided.boxes),
                                   np.asarray(out_ref.boxes), atol=0.05)
        if n % stride == 0:
            _, out_b = scan.run_sequence_strided_batched(
                bank0, frames, det.params, cfg, spec, stride,
                score_thr=0.2)
            np.testing.assert_array_equal(np.asarray(out_b.ids),
                                          np.asarray(out_strided.ids))
            np.testing.assert_array_equal(np.asarray(out_b.cls),
                                          np.asarray(out_strided.cls))


def test_synthetic_class_fixture():
    """Class-keyed synthetic fixtures: distinct texture families per
    class (inside the box only — background identical), 6-col detections
    carrying the object classes, and a bit-identical default path (the
    rng stream must not move for n_classes=1 — goldens depend on it)."""
    from jaxmot.data import synthetic

    # Same object, different class → frames differ inside the box only.
    frames = {}
    for cls in (0, 1, 2):
        o = synthetic.SyntheticObject(cx=80, cy=60, w=24, h=24, vx=0,
                                      vy=0, cls=cls)
        f, b, v = synthetic.render_sequence([o], 2, 120, 160, seed=9,
                                            noise=0.0)
        frames[cls] = f[0]
    inside = np.s_[60 - 10:60 + 10, 80 - 10:80 + 10]
    for a, b in [(0, 1), (1, 2), (0, 2)]:
        assert np.abs(frames[a][inside] - frames[b][inside]).max() > 0.2
    outside = frames[0].copy()
    outside[60 - 14:60 + 14, 80 - 14:80 + 14] = 0
    for cls in (1, 2):
        other = frames[cls].copy()
        other[60 - 14:60 + 14, 80 - 14:80 + 14] = 0
        np.testing.assert_array_equal(outside, other)

    # Stripes really are stripes: strong row-to-row flips.
    stripe_patch = frames[1][inside]
    speckle_patch = frames[0][inside]
    row_flip = lambda p: np.abs(np.diff(p, axis=0)).mean()
    col_flip = lambda p: np.abs(np.diff(p, axis=1)).mean()
    assert col_flip(stripe_patch) < 0.3 * row_flip(stripe_patch)
    assert col_flip(speckle_patch) > 0.5 * row_flip(speckle_patch)

    # make_objects class assignment + 6-col detections.
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(10, 120, 160, rng, n_classes=3)
    classes = np.asarray([o.cls for o in objs])
    assert set(classes.tolist()) <= {0, 1, 2}
    assert len(set(classes.tolist())) >= 2
    fr, boxes, vis = synthetic.render_sequence(objs, 3, 120, 160, seed=1)
    dets = synthetic.detections_from_gt(boxes, vis, seed=1,
                                        classes=classes)
    for f in range(3):
        assert dets[f].shape[1] == 6
        # Jitter is small: recover each det's source object by nearest
        # center and check the class column matches.
        for row in dets[f]:
            d2 = ((boxes[f, :, 0] - row[0]) ** 2
                  + (boxes[f, :, 1] - row[1]) ** 2)
            d2[~vis[f]] = 1e18
            assert row[5] == classes[int(np.argmin(d2))]

    # Default path draws nothing extra from the rng stream.
    rng_a = np.random.default_rng(4)
    rng_b = np.random.default_rng(4)
    a = synthetic.make_objects(4, 120, 160, rng_a)
    b = synthetic.make_objects(4, 120, 160, rng_b, n_classes=1)
    assert float(rng_a.random()) == float(rng_b.random())
    assert [o.cx for o in a] == [o.cx for o in b]


def test_bounce_gate_and_best_assoc_matrix():
    """Identical-texture elastic bounce at 4 px/frame (KCF appearance
    cannot disambiguate — the pixels match): class-blind tracking swaps
    ids; the class gate alone refuses the swap but fragments (the KCF
    template locked onto the look-alike, so the refined box never
    re-overlaps the right detection); gate + assoc_box="best" (the
    Kalman hypothesis rides along in the cost) recovers identity
    completely.  Pins examples/class_aware_mot.py's demo numbers."""
    from jaxmot.data import synthetic
    from jaxmot.tracker import bank as bank_mod, scan
    from jaxmot.utils import metrics

    h, w, n_frames, speed = 240, 320, 40, 4.0
    meet, y = 160.0, 120.0
    f_meet = n_frames // 2
    t = np.arange(n_frames)
    cx1 = np.where(t <= f_meet, meet - speed * (f_meet - t),
                   meet - speed * (t - f_meet))
    centers = np.zeros((n_frames, 2, 2))
    centers[:, 0] = np.stack([cx1, np.full(n_frames, y - 1.0)], -1)
    centers[:, 1] = np.stack([2 * meet - cx1,
                              np.full(n_frames, y + 1.0)], -1)
    sizes = np.asarray([[20.0, 20.0], [20.0, 20.0]])
    classes = np.asarray([0, 1], np.int64)
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, h, w, seed=42, tex_levels=[0.45, 0.45])
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=1, jitter=1.0, frame_hw=(h, w), classes=classes)

    def run(aware, abox):
        cfg = _cfg(max_tracks=16, max_detections=16, frame_height=h,
                   frame_width=w, n_init=2, use_kcf=True,
                   class_aware=aware, assoc_box=abox)
        d = np.zeros((n_frames, 16, 6), np.float32)
        v = np.zeros((n_frames, 16), bool)
        for f in range(n_frames):
            d[f], v[f] = pad_detections(dets_list[f], 16)
        dj = jnp.asarray(d if aware else d[..., :5])
        _, outs = scan.run_sequence(bank_mod.empty_bank(cfg),
                                    jnp.asarray(frames), dj,
                                    jnp.asarray(v), cfg)
        ids = np.asarray(outs.ids)
        bxs = np.asarray(outs.boxes)
        val = np.asarray(outs.valid)
        hyp = [(ids[f, val[f]], bxs[f, val[f]]) for f in range(n_frames)]
        gt = [(np.where(vis[f])[0], boxes[f, vis[f]])
              for f in range(n_frames)]
        m = metrics.clear_mot(gt, hyp)
        return m["idf1"], m["idsw"]

    idf1_blind, idsw_blind = run(False, "refined")
    assert idf1_blind < 0.6 and idsw_blind >= 2          # the swap
    idf1_gate, _ = run(True, "refined")
    assert idf1_gate > idf1_blind                        # gate helps...
    idf1_best, idsw_best = run(True, "best")
    assert idf1_best > 0.95 and idsw_best == 0           # ...best rescues
    assert idf1_best >= idf1_gate
    # Default trap: the DEFAULT assoc_box="auto"
    # must land class_aware users in the rescued regime, not the
    # gate-only phantom-coasting one.
    idf1_auto, idsw_auto = run(True, "auto")
    assert idf1_auto == idf1_best and idsw_auto == idsw_best


def test_assoc_box_auto_resolution():
    """assoc_box="auto" couples to class_aware: "refined" single-class
    (the reference's appearance-blended association), "best" class-aware
    (the bounce fixture above)."""
    from jaxmot.config import TrackerConfig

    assert TrackerConfig().assoc_box_resolved == "refined"
    assert TrackerConfig(class_aware=True).assoc_box_resolved == "best"
    # Explicit settings always win over the coupling.
    assert TrackerConfig(class_aware=True,
                         assoc_box="refined").assoc_box_resolved == "refined"
    assert TrackerConfig(assoc_box="best").assoc_box_resolved == "best"


def test_track_sequence_six_col_detections():
    """track_sequence (the cmd_video --class-aware path) must accept
    6-column per-frame detection lists — the buffer width follows the
    input (caught by review: the hardcoded [*, 5] buffer crashed on the
    first class-aware frame)."""
    from jaxmot.tracker import scan

    frame = np.zeros((3, 120, 160), np.float32)
    dets = [np.asarray([[40.0, 60, 16, 16, 1.0, 1.0]], np.float32),
            np.asarray([[44.0, 60, 16, 16, 1.0, 1.0]], np.float32),
            np.zeros((0, 6), np.float32)]       # empty frame too
    cfg = _cfg(class_aware=True)
    bank, tracks, outs = scan.track_sequence(frame, dets, cfg)
    assert np.asarray(outs.cls).max() == 1      # class carried through
