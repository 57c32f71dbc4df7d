"""Adversarial association fixtures: scenarios where
motion-only (IoU/Kalman) association demonstrably mis-assigns, codifying
the evidence behind the appearance_weight=0.0 default.

Finding (tools/sweep_appearance.py):
appearance INFORMATION matters — distinct-texture crossings keep identity
where identical textures swap — but it enters through KCF box refinement
(which precedes the cost), so the explicit cost-blend weight is measured
neutral at every value.  These tests pin both halves of that claim.
"""

import numpy as np

from jaxmot.config import TrackerConfig
from jaxmot.data import synthetic
from jaxmot.tracker import scan
from jaxmot.utils import metrics

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


def _run_bounce(tex_levels, appearance_weight, seed=0):
    from sweep_appearance import _bounce_tracks

    n = 40
    centers = _bounce_tracks(n)
    sizes = np.asarray([[28.0, 28.0], [26.0, 30.0]], np.float32)
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, 240, 320, seed=seed, noise=0.02,
        tex_levels=tex_levels)
    dets = synthetic.detections_from_gt(boxes, vis, seed=seed, jitter=1.0,
                                        frame_hw=(240, 320))
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=240,
                        frame_width=320, n_init=2,
                        appearance_weight=appearance_weight)
    _, tracks, _ = scan.track_sequence(frames, dets, cfg)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n)]
    hyp = [(np.asarray([t[0] for t in tr]),
            np.asarray([t[1] for t in tr]).reshape(-1, 4))
           for tr in tracks]
    return metrics.clear_mot(gt, hyp)


def test_texture_rescues_motion_reversal_crossing():
    """Two targets bounce off each other (constant-velocity prediction
    continues through) — with distinct textures the KCF refinement keeps
    identities; with identical textures the IDs swap.  This is the
    appearance signal working, upstream of the cost matrix."""
    m_distinct = _run_bounce([0.7, 0.05], appearance_weight=0.0)
    m_similar = _run_bounce([0.45, 0.45], appearance_weight=0.0)
    assert m_distinct["idf1"] > 0.9, m_distinct
    assert m_distinct["idsw"] == 0, m_distinct
    assert m_similar["idf1"] < m_distinct["idf1"] - 0.2, (
        m_similar, m_distinct)


def test_appearance_cost_blend_is_neutral_given_refinement():
    """The explicit cost-blend weight does not change the outcome on the
    same adversarial fixture — the measured basis for the 0.0 default
    (config.py).  If a refactor makes this assert fail with the blend
    WINNING, celebrate and re-sweep the default."""
    m0 = _run_bounce([0.7, 0.05], appearance_weight=0.0)
    m2 = _run_bounce([0.7, 0.05], appearance_weight=0.2)
    assert m0["idf1"] == m2["idf1"], (m0, m2)
    assert m0["idsw"] == m2["idsw"], (m0, m2)
