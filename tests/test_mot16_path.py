"""MOT16 directory pipeline (BASELINE configs[0] shape): synthesize a
MOT16-format sequence dir from the fixture, run the CLI path end-to-end,
score the written result file with the external-format readers."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from jaxmot.data import mot as mot_data
from jaxmot.data import synthetic
from jaxmot.utils import metrics


@pytest.fixture(scope="module")
def mot_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("MOT16-99")
    img = root / "img1"
    det = root / "det"
    gt = root / "gt"
    for d in (img, det, gt):
        d.mkdir()
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(8, 240, 320, rng, max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, 20, 240, 320,
                                                   seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(240, 320))
    with open(det / "det.txt", "w") as f:
        for fi, d in enumerate(dets, start=1):
            for cx, cy, w, h, s in d:
                f.write(f"{fi},-1,{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},{s:.3f},-1,-1,-1\n")
    with open(gt / "gt.txt", "w") as f:
        for fi in range(1, 21):
            for k in np.where(vis[fi - 1])[0]:
                cx, cy, w, h = boxes[fi - 1, k]
                f.write(f"{fi},{k + 1},{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},1,1,1.0\n")
    for i, fr in enumerate(frames, start=1):
        cv2.imwrite(str(img / f"{i:06d}.jpg"),
                    (fr * 255).astype(np.uint8))
    return str(root)


def test_cli_mot_sequence_dir(mot_dir, tmp_path):
    from jaxmot.cli import main

    out = str(tmp_path / "res.txt")
    rc = main(["mot", "--seq", mot_dir, "--out", out, "--score",
               "--max-tracks", "16", "--max-dets", "16"])
    assert rc == 0
    assert os.path.exists(out)
    # Round-trip: parse our own result file with the det reader and score.
    res = np.loadtxt(out, delimiter=",", ndmin=2)
    assert res.shape[1] == 10
    gt = mot_data.load_mot_gt(os.path.join(mot_dir, "gt", "gt.txt"))
    hyp = []
    for fi in range(1, 21):
        rows = res[res[:, 0] == fi]
        ids = rows[:, 1].astype(int)
        b = mot_data.tlwh_to_cxcywh(rows[:, 2:6])
        hyp.append((ids, b))
    m = metrics.clear_mot(gt, hyp)
    assert m["mota"] > 0.7, m


def test_det_reader_against_native(mot_dir):
    """Python and C++ det.txt parsers agree."""
    from jaxmot import native

    path = os.path.join(mot_dir, "det", "det.txt")
    py = mot_data.load_mot_dets(path)
    if native.ensure_built():
        raw = native.parse_mot_csv(path)
        n_py = sum(len(d) for d in py)
        assert raw.shape[0] == n_py
        first = raw[raw[:, 0] == 1]
        np.testing.assert_allclose(
            mot_data.tlwh_to_cxcywh(first[:, 2:6]), py[0][:, :4],
            rtol=1e-5)


def test_gt_reader(mot_dir):
    gt = mot_data.load_mot_gt(os.path.join(mot_dir, "gt", "gt.txt"))
    assert len(gt) == 20
    ids, boxes = gt[0]
    assert len(ids) == len(boxes) and len(ids) >= 6


def test_video_roundtrip_and_chunked_pipeline(tmp_path):
    from jaxmot.data.video import read_video, ChunkedVideoPipeline
    from jaxmot.utils.viz import write_video

    frames = (np.random.default_rng(0).random((9, 48, 64)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "v.mp4")
    write_video(path, [(f, []) for f in frames], fps=10)
    back = read_video(path)
    assert back.shape == (9, 48, 64)

    chunks = list(ChunkedVideoPipeline(back, chunk=4))
    assert [len(c) for c in chunks] == [4, 4, 1]
    np.testing.assert_array_equal(np.concatenate(chunks), back)


def test_cli_eval_aggregate(mot_dir, tmp_path, capsys):
    """`jaxmot eval --root` runs every sequence under a root and prints
    per-sequence + OVERALL CLEAR-MOT rows (error-sum aggregation)."""
    import json
    import shutil
    from jaxmot.cli import main

    root = tmp_path / "train"
    root.mkdir()
    # Two copies of the synthetic sequence = a 2-sequence benchmark dir.
    shutil.copytree(mot_dir, root / "SEQ-01")
    shutil.copytree(mot_dir, root / "SEQ-02")
    out_dir = str(tmp_path / "res")
    rc = main(["eval", "--root", str(root), "--out-dir", out_dir,
               "--max-tracks", "16", "--max-dets", "16"])
    assert rc == 0
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()
            if ln.startswith("{")]
    names = [r["seq"] for r in rows]
    assert names == ["SEQ-01", "SEQ-02", "OVERALL"]
    overall = rows[-1]
    assert overall["sequences"] == 2
    # Identical sequences: aggregate MOTA equals the per-seq MOTA and the
    # tracker must actually track (well above chance).
    assert abs(overall["mota"] - rows[0]["mota"]) < 1e-6
    assert overall["mota"] > 0.5
    assert os.path.exists(os.path.join(out_dir, "SEQ-01.txt"))
    assert os.path.exists(os.path.join(out_dir, "SEQ-02.txt"))


def test_cli_video_strided_detector(tmp_path, capsys):
    """`jaxmot video --det-stride N`: detect+track a tiny clip with the
    detector running every Nth frame inside the scanned cond."""
    import numpy as np
    from jaxmot.cli import main

    frames = (np.random.default_rng(0).random((6, 96, 128)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "clip.mp4")
    try:
        from jaxmot.utils.viz import write_video
        write_video(path, [(f, []) for f in frames], fps=10)
    except Exception:
        import pytest
        pytest.skip("video writer unavailable")
    rc = main(["video", "--input", path, "--model", "yolov2-tiny",
               "--classes", "1", "--det-stride", "3", "--max-dets", "8",
               "--max-tracks", "8", "--chunk", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "detect+track" in out
