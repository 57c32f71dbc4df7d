"""chip_smoke.py: its contract helpers, and every phase rehearsed on the
CPU at a tiny size (the card runs them at full size)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_last_line_format():
    line = cs.final_line([_Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(cs.final_line([_Dev()] * 4))["device"]["count"] == 4


def test_refuses_non_gpu_backend():
    with pytest.raises(SystemExit):
        cs.require_gpu("cpu")
    cs.require_gpu("gpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_selection():
    assert cs.select_phases(4) == ("multicard",)
    one = cs.select_phases(1)
    assert "multicard" not in one
    assert set(one) == {"tracker_default", "tracker_heavy", "api",
                        "detect_track", "compare", "precision"}
    assert set(cs.PHASES) == set(one) | {"multicard"}
    with pytest.raises(ValueError):
        cs.select_phases(2)


def _tiny_fixture():
    return cs.bench_fixture(120, 160, n_obj=6, n_frames=8, max_dets=16)


def _spec_tiny():
    from jaxmot.models.yolo import YOLOV2_TINY_ANCHORS, YoloSpec
    return YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)


REHEARSALS = {
    "tracker_default": lambda: cs.tracker_phase(
        "tiny", fixture=_tiny_fixture(), min_mota=0.5, reps=1),
    "tracker_heavy": lambda: cs.tracker_phase(
        "tiny", kcf=cs._heavy_kcf(), fixture=_tiny_fixture(), min_mota=0.5,
        reps=1),
    "api": lambda: cs.api_phase(fixture=_tiny_fixture(), n_updates=4),
    "detect_track": lambda: cs.detect_track_phase(
        height=224, width=320, n_frames=4, max_dets=16, reps=1),
    "compare_roi": lambda: [cs.compare_roi(120, 160, 12, u8=u8, scales=sc)
                            for u8 in (False, True)
                            for sc in (None, (1 / 1.05, 1.0, 1.05))],
    "compare_kcf": lambda: [cs.compare_kcf(n=3, channels=c)
                            for c in (1, 31)],
    "compare_auction": lambda: cs.compare_auction(n=24, m=30, n_problems=3),
    "compare_kalman": lambda: cs.compare_kalman(n=8),
    "compare_yolo_heads": lambda: cs.compare_yolo_heads(size=64, batch=1),
    "compare_yolo_int8": lambda: cs.compare_yolo_int8(size=64, batch=1),
    "compare_goldens": lambda: cs.compare_goldens(),
    "multicard": lambda: cs.multicard_phase(
        4, 8, 64, 96, n_frames=8, stride=4, max_tracks=8, max_dets=8,
        spec=_spec_tiny(), obj_size=(8, 16)),
}


@pytest.mark.parametrize("name", sorted(REHEARSALS))
def test_phase_rehearsal_tiny(name):
    if name == "multicard" and len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    REHEARSALS[name]()


def test_tolerance_miss_raises():
    with pytest.raises(cs.ToleranceError):
        cs.check("x", 2e-5, 1e-5, "err")
    with pytest.raises(cs.ToleranceError):
        cs.check_floor("x", 0.5, 0.9, "score")
    assert cs.rel_err(np.ones(3), np.ones(3)) == 0.0


def test_match_boxes_ignores_slot_order():
    a = np.array([[10., 20., 4., 4.], [300., 40., 8., 8.]])
    assert cs.match_boxes(a, a[::-1]) == 0.0
    assert cs.match_boxes(a, a[::-1] + 0.5) == 0.5
    assert cs.match_boxes(a, a[:1]) == float("inf")
    assert cs.match_boxes(a[:0], a[:0]) == 0.0


def test_stream_diff_separates_permutation_from_change():
    from types import SimpleNamespace
    boxes = np.array([[[10., 20., 4., 4.], [300., 40., 8., 8.]]])
    ids = np.array([[1, 2]])
    valid = np.ones((1, 2), bool)
    a = SimpleNamespace(ids=ids, valid=valid, boxes=boxes)
    swapped = SimpleNamespace(ids=ids, valid=valid, boxes=boxes[:, ::-1])
    d = cs.stream_diff(a, swapped)
    assert d["ids_equal"] and d["valid_equal"]
    assert d["slot_px"] == 290.0 and d["set_px"] == 0.0
    moved = SimpleNamespace(ids=ids, valid=valid, boxes=boxes + 1.0)
    assert cs.stream_diff(a, moved)["set_px"] == 1.0
