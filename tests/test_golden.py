"""Golden-file regression (SURVEY.md §4.5): fixed seed + fixed detections
→ exact track-ID/box dump, compared against a committed golden file so
refactors that change numerics are caught deliberately.

Two configs are pinned: the default (gray features, unit scale) and the
reference-faithful heavy config (fHOG-31 + 3-scale search) so the heavy
path — which historically had no golden at all —
also catches numerics regressions.

Regenerate after an INTENTIONAL behavior change:
    python tests/test_golden.py regen
"""

import os
import sys

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(_DIR, "mot_synthetic_v1.npz")
GOLDEN_HEAVY = os.path.join(_DIR, "mot_synthetic_hog_scale_v1.npz")


def fixture():
    """The golden scene: (frames, gt boxes, gt visibility, detections)."""
    from jaxmot.data import synthetic

    rng = np.random.default_rng(42)
    objs = synthetic.make_objects(10, 240, 320, rng, max_speed=2.5)
    frames, boxes, vis = synthetic.render_sequence(objs, 25, 240, 320,
                                                   seed=42)
    dets = synthetic.detections_from_gt(boxes, vis, seed=42,
                                        frame_hw=(240, 320))
    return frames, boxes, vis, dets


def _run(heavy: bool = False, kcf_precision: str = "auto"):
    from jaxmot.config import KCFConfig, TrackerConfig
    from jaxmot.tracker import scan

    frames, _, _, dets = fixture()
    kcf = (KCFConfig(feature_type="hog", cell_size=4, scale_step=1.05)
           if heavy else KCFConfig())
    cfg = TrackerConfig(max_tracks=32, max_detections=16,
                        frame_height=240, frame_width=320,
                        kcf=kcf, kcf_precision=kcf_precision)
    _, _, out = scan.track_sequence(frames, dets, cfg)
    return out


def _check(out, path):
    g = np.load(path)
    np.testing.assert_array_equal(out.ids, g["ids"])
    np.testing.assert_array_equal(out.valid, g["valid"])
    # Bit-exactness is the goal on identical software; allow only
    # float-noise drift so a compiler update doesn't mask real changes.
    np.testing.assert_allclose(out.boxes, g["boxes"], rtol=0, atol=1e-3)


def test_golden_mot_dump():
    if not os.path.exists(GOLDEN):
        import pytest
        pytest.skip("golden file not generated yet")
    _check(_run(), GOLDEN)


def test_golden_mot_dump_hog_scale():
    """Heavy-config golden: fHOG features + 3-scale batched search."""
    if not os.path.exists(GOLDEN_HEAVY):
        import pytest
        pytest.skip("heavy golden file not generated yet")
    _check(_run(heavy=True), GOLDEN_HEAVY)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import jax
        jax.config.update("jax_platforms", "cpu")
        os.makedirs(_DIR, exist_ok=True)
        for heavy, path in ((False, GOLDEN), (True, GOLDEN_HEAVY)):
            out = _run(heavy=heavy)
            np.savez_compressed(path, ids=np.asarray(out.ids),
                                valid=np.asarray(out.valid),
                                boxes=np.asarray(out.boxes))
            print(f"wrote {path}")
