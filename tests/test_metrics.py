"""Hand-computed CLEAR-MOT / IDF1 fixture.

utils.metrics.clear_mot is the judge of every MOTA claim in this repo, so
it gets a multi-frame fixture whose FP/FN/IDSW/MOTA/IDF1 are worked out on
paper below, independent of the implementation.  motmetrics is not
installable in this environment (no network), so paper is the oracle.
"""

import numpy as np

from jaxmot.utils.metrics import clear_mot


def _box(x, y):
    return [x, y, 4.0, 4.0]


def _fixture():
    """6 frames, 2 GT tracks (A=0, B=1), 4 hypothesis ids (1, 2, 3, 4).

    Layout (positions static, so every true match has IoU == 1.0):
      GT A at (10, 10) frames 1-6;  GT B at (30, 30) frames 1-6.
      h1 covers A frames 1-3.
      h2 covers A frames 4-6.          -> 1 ID switch (A: h1 -> h2 at f4)
      h3 covers B frames 1-2 and 4-6.  -> B missed in frame 3 (1 FN);
                                          re-acquiring the SAME id after a
                                          gap is NOT a switch (CLEAR rule)
      h4 at (60, 60) frame 5 only.     -> 1 FP

    Paper totals:
      n_gt   = 2 tracks x 6 frames               = 12
      FN     = 1 (B, frame 3)
      FP     = 1 (h4, frame 5)
      IDSW   = 1 (A at frame 4)
      MOTA   = 1 - (1 + 1 + 1) / 12              = 0.75
      MOTP   = mean matched IoU                  = 1.0
      matches = 2+2+1+2+2+2                      = 11
      recall = 11 / 12;  precision = 11 / 12 (n_hyp = 3+3+5+1 = 12)
      IDF1: co-occurrence (A,h1)=3, (A,h2)=3, (B,h3)=5; optimal global
        match A->h1 (or h2) + B->h3 gives IDTP = 3 + 5 = 8;
        IDF1 = 2*8 / (12 + 12)                   = 2/3
      MT/ML: A tracked 6/6, B 5/6 — both >= 0.8  -> MT = 1.0, ML = 0.0
    """
    a, b = _box(10, 10), _box(30, 30)
    gt = [([0, 1], [a, b])] * 6
    hyp = [
        ([1, 3], [a, b]),                 # f1
        ([1, 3], [a, b]),                 # f2
        ([1], [a]),                       # f3: B missed
        ([2, 3], [a, b]),                 # f4: A switches to h2
        ([2, 3, 4], [a, b, _box(60, 60)]),  # f5: + false positive
        ([2, 3], [a, b]),                 # f6
    ]
    return gt, hyp


def test_clear_mot_hand_computed_fixture():
    gt, hyp = _fixture()
    m = clear_mot(gt, hyp, iou_thr=0.5)
    assert m["n_gt"] == 12
    assert m["fn"] == 1
    assert m["fp"] == 1
    assert m["idsw"] == 1
    np.testing.assert_allclose(m["mota"], 0.75)
    np.testing.assert_allclose(m["motp"], 1.0)
    np.testing.assert_allclose(m["recall"], 11 / 12)
    np.testing.assert_allclose(m["precision"], 11 / 12)
    np.testing.assert_allclose(m["idf1"], 2 / 3)
    assert m["mostly_tracked"] == 1.0
    assert m["mostly_lost"] == 0.0


def test_clear_match_persistence_beats_greedy_iou():
    """CLEAR persists the previous pairing even when a different hypothesis
    now overlaps slightly better — prevents spurious switch counting.

    One GT track at (10, 10); h1 matched it in frame 1.  In frame 2, h1
    drifts 1 px (IoU ~ 0.78, still >= 0.5) while a new h2 sits exactly on
    the GT (IoU = 1.0).  Persistence keeps GT->h1, so h2 is the FP and
    IDSW stays 0 (greedy re-matching would report IDSW=1 as h2 steals it).
    """
    g = _box(10, 10)
    gt = [([0], [g]), ([0], [g])]
    hyp = [([1], [g]), ([1, 2], [_box(11, 10), g])]
    m = clear_mot(gt, hyp, iou_thr=0.5)
    assert m["idsw"] == 0
    assert m["fp"] == 1
    assert m["fn"] == 0
    np.testing.assert_allclose(m["mota"], 1.0 - 1 / 2)


def test_clear_empty_frames_and_no_hyp():
    gt = [([0], [_box(5, 5)]), ([], np.zeros((0, 4)))]
    hyp = [([], np.zeros((0, 4)))] * 2
    m = clear_mot(gt, hyp)
    assert m["fn"] == 1 and m["fp"] == 0 and m["idsw"] == 0
    np.testing.assert_allclose(m["mota"], 0.0)
    assert m["idf1"] == 0.0


# ---------------------------------------------------------------------
# HOTA (utils.metrics.hota) — hand-computed oracles per the IJCV 2020
# definitions (TrackEval is not installable here; paper is the oracle).
# ---------------------------------------------------------------------

def _hota_seq(frames):
    from jaxmot.utils.metrics import hota
    return hota(*zip(*frames))


def test_hota_perfect():
    """Identical GT and hypothesis → every component is exactly 1."""
    frames = [(([0, 1], [_box(10, 10), _box(30, 30)]),
               ([5, 7], [_box(10, 10), _box(30, 30)]))
              for _ in range(6)]
    m = _hota_seq(frames)
    for k in ("hota", "deta", "assa", "loca"):
        assert abs(m[k] - 1.0) < 1e-9, (k, m[k])


def test_hota_id_switch():
    """One GT track over 2N frames, the hypothesis splits it in half
    (id 1 then id 2), boxes exact.  Paper arithmetic: DetA = 1 (every
    frame a TP at any alpha); for each TP of pair (g, h): TPA = N,
    FNA = N (g's other-half frames matched to the other id), FPA = 0,
    so A = N/2N = 0.5 for all 2N TPs → AssA = 0.5,
    HOTA = sqrt(1 * 0.5)."""
    n = 4
    frames = [(([0], [_box(10, 10)]),
               ([1 if t < n else 2], [_box(10, 10)]))
              for t in range(2 * n)]
    m = _hota_seq(frames)
    assert abs(m["deta"] - 1.0) < 1e-9
    assert abs(m["assa"] - 0.5) < 1e-9
    assert abs(m["hota"] - np.sqrt(0.5)) < 1e-9
    assert abs(m["loca"] - 1.0) < 1e-9


def test_hota_half_missed():
    """One GT track over 2N frames, hypothesis covers only the first N
    (same id, boxes exact).  DetA = N/(N + N FN) = 0.5; each TP's pair:
    TPA = N, FNA = N (unmatched gt frames), FPA = 0 → AssA = 0.5;
    HOTA = 0.5.  (CLEAR-MOT would call this MOTA 0.5 with no IDSW —
    HOTA additionally charges association for the missing half.)"""
    n = 4
    frames = []
    for t in range(2 * n):
        gt = ([0], [_box(10, 10)])
        hyp = ([1], [_box(10, 10)]) if t < n else ([], np.zeros((0, 4)))
        frames.append((gt, hyp))
    m = _hota_seq(frames)
    assert abs(m["deta"] - 0.5) < 1e-9
    assert abs(m["assa"] - 0.5) < 1e-9
    assert abs(m["hota"] - 0.5) < 1e-9


def test_hota_localization_sweep():
    """A hypothesis at constant IoU ~0.58 vs GT: TPs exist only for
    alphas below that IoU, so DetA_alpha steps from 1 to 0 across the
    sweep and HOTA averages the per-alpha scores."""
    # 4x4 box shifted by 1 px in x: inter = 3*4, union = 2*16 - 12 = 20,
    # IoU = 0.6.
    frames = [(([0], [_box(10, 10)]), ([1], [_box(11, 10)]))
              for _ in range(5)]
    m = _hota_seq(frames)
    alphas = m["alphas"]
    want = np.where(alphas <= 0.6 + 1e-9, 1.0, 0.0)
    np.testing.assert_allclose(m["hota_alpha"], want, atol=1e-9)
    assert abs(m["hota"] - want.mean()) < 1e-9
    # LocA averages per-alpha mean-TP-IoU over ALL alphas (zero-TP alphas
    # contribute 0 — the TrackEval/paper integration convention).
    assert abs(m["loca"] - 0.6 * want.mean()) < 1e-6


def test_hota_empty_inputs():
    from jaxmot.utils.metrics import hota
    e = ([], np.zeros((0, 4)))
    assert hota([e], [e])["hota"] == 1.0          # vacuously perfect
    g = ([0], [_box(10, 10)])
    assert hota([g], [e])["hota"] == 0.0          # all FN
    assert hota([e], [g])["hota"] == 0.0          # all FP
