"""Native C++ runtime tests: build, exact assignment vs SciPy, CSV parse,
gray conversion, frame ring (SURVEY.md §2 native-component checklist)."""

import numpy as np
import pytest

from jaxmot import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.ensure_built():
        pytest.skip("g++ unavailable — native lib not built")


def test_assign_exact_vs_scipy():
    from jaxmot.ops.assignment import scipy_assign, assignment_cost

    rng = np.random.default_rng(0)
    for shape in [(5, 5), (12, 7), (7, 12), (40, 40), (1, 1)]:
        cost = rng.uniform(0, 2, shape).astype(np.float64)
        feasible = rng.random(shape) > 0.3
        got = native.assign(cost, feasible)
        want = scipy_assign(cost, feasible)
        assert (got >= 0).sum() == (want >= 0).sum()
        np.testing.assert_allclose(assignment_cost(cost, got),
                                   assignment_cost(cost, want), rtol=1e-9)
        matched = got[got >= 0]
        assert len(set(matched.tolist())) == len(matched)
        for r, c in enumerate(got):
            if c >= 0:
                assert feasible[r, c]


def test_assign_all_infeasible():
    got = native.assign(np.ones((3, 3)), np.zeros((3, 3), bool))
    assert (got == -1).all()


def test_parse_mot_csv(tmp_path):
    p = tmp_path / "det.txt"
    p.write_text("1,-1,10.5,20,30,40,0.9,-1,-1,-1\n"
                 "2,-1,11,21,31,41,0.8,-1,-1,-1\n"
                 "garbage line\n"
                 "3,-1,12,22,32,42,0.7\n")
    rows = native.parse_mot_csv(str(p))
    assert rows.shape == (3, 7)
    np.testing.assert_allclose(rows[0], [1, -1, 10.5, 20, 30, 40, 0.9])
    np.testing.assert_allclose(rows[2], [3, -1, 12, 22, 32, 42, 0.7])


def test_bgr_to_gray_matches_numpy():
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (32, 48, 3), np.uint8)
    got = native.bgr_to_gray(bgr)
    b = bgr.astype(np.uint32)
    want = ((77 * b[..., 2] + 150 * b[..., 1] + 29 * b[..., 0]) >> 8
            ).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_frame_ring_spsc():
    ring = native.FrameRing(capacity=4, frame_bytes=64)
    frames = [np.arange(64, dtype=np.uint8) + i for i in range(6)]
    assert len(ring) == 0
    for i in range(4):
        assert ring.push(frames[i])
    assert not ring.push(frames[4])          # full
    assert len(ring) == 4
    out = ring.pop((64,))
    np.testing.assert_array_equal(out, frames[0])
    assert ring.push(frames[4])               # space again
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(ring.pop((64,)), frames[i])
    assert ring.pop((64,)) is None


import pytest


@pytest.mark.parametrize("backend", ["native", "fallback"])
def test_stream_scheduler(backend, monkeypatch):
    """Multi-stream batch assembly: per-stream rings, repeat-last policy,
    drop accounting — native and pure-Python backends behave the same."""
    from jaxmot import native as native_mod

    if backend == "native" and not native_mod.ensure_built():
        pytest.skip("toolchain unavailable")
    if backend == "fallback":
        monkeypatch.setattr(native_mod, "ensure_built", lambda *a: False)

    sched = native_mod.StreamScheduler(3, frame_shape=(4, 6), capacity=2)
    assert (sched._native is True) == (backend == "native")

    f = lambda v: np.full((4, 6), v, np.uint8)
    # Incomplete batch: stream 2 never pushed.
    sched.push(0, f(1))
    sched.push(1, f(2))
    assert sched.gather() is None

    sched.push(2, f(3))
    batch, fresh = sched.gather()
    assert batch.shape == (3, 4, 6)
    assert fresh.all()
    np.testing.assert_array_equal(batch[:, 0, 0], [1, 2, 3])

    # Stream 1 goes silent: its last frame repeats, others stay fresh.
    sched.push(0, f(10))
    sched.push(2, f(30))
    batch, fresh = sched.gather()
    np.testing.assert_array_equal(batch[:, 0, 0], [10, 2, 30])
    np.testing.assert_array_equal(fresh, [True, False, True])

    # Overflow: capacity 2, third push drops and is counted.
    assert sched.push(0, f(41))
    assert sched.push(0, f(42))
    assert not sched.push(0, f(43))
    stats = sched.stats()
    assert stats["dropped"] == [1, 0, 0]
    assert stats["repeated"] == [0, 1, 0]

    # FIFO order preserved through the ring.
    batch, _ = sched.gather()
    assert batch[0, 0, 0] == 41
    batch, _ = sched.gather()
    assert batch[0, 0, 0] == 42


def test_stream_scheduler_threaded_producers():
    """Decoders on real threads at different rates; the gather loop always
    produces complete batches and per-stream frames arrive in order."""
    import threading

    from jaxmot import native as native_mod

    if not native_mod.ensure_built():
        pytest.skip("toolchain unavailable")
    import time

    n_streams, n_frames = 4, 50
    # Capacity >= n_frames so producers never block on the consumer (a
    # bounded-capacity spin here can deadlock the TEST if the gather loop
    # bails before producers finish).
    sched = native_mod.StreamScheduler(n_streams, frame_shape=(2, 2),
                                       capacity=n_frames)

    def producer(sid):
        for k in range(n_frames):
            frame = np.full((2, 2), (sid * n_frames + k) % 251, np.uint8)
            assert sched.push(sid, frame)
            time.sleep(0.0005 * (sid + 1))     # uneven decode rates

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(n_streams)]
    for t in threads:
        t.start()
    seen = [[] for _ in range(n_streams)]
    deadline = time.monotonic() + 60.0
    while (not all(len(v) >= n_frames for v in seen)
           and time.monotonic() < deadline):
        got = sched.gather()
        if got is None:
            time.sleep(0.001)
            continue
        batch, fresh = got
        for s in range(n_streams):
            if fresh[s]:
                seen[s].append(int(batch[s, 0, 0]))
    for t in threads:
        t.join()
    for s in range(n_streams):
        want = [(s * n_frames + k) % 251 for k in range(n_frames)]
        assert seen[s][:n_frames] == want
