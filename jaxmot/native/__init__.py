"""ctypes bindings for the native host runtime (libjaxmot.so).

The compute path is JAX/XLA on the accelerator; the host runtime around it
is C++ like the reference's (SURVEY.md §2): an exact Hungarian assignment
solver, a MOT det-file parser, BGR→gray conversion, and an SPSC frame ring
buffer for decode→device staging.  Built on demand with `make` (g++);
every entry point has a pure-Python fallback, so the framework works
without the library.

  from jaxmot import native
  native.ensure_built()            # compiles libjaxmot.so if missing
  row_to_col = native.assign(cost, feasible)
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libjaxmot.so")
_lib = None


def ensure_built(quiet: bool = True) -> bool:
    """Build/refresh libjaxmot.so. Returns availability.

    Fast path: when the .so is newer than every src/*.cc and the
    Makefile, skip the make subprocess entirely — spawning make on every
    fresh process (pytest workers, CLI runs, schedulers) costs real time
    and fails noisily on hosts without a toolchain."""
    global _lib
    if _lib is None and not _so_current():
        try:
            subprocess.run(["make", "-C", _DIR],
                           capture_output=quiet, check=True)
        except Exception:
            pass                      # fall through to any existing .so
    return _load()


def _so_current() -> bool:
    if not os.path.exists(_LIB_PATH):
        return False
    so_mtime = os.path.getmtime(_LIB_PATH)
    deps = [os.path.join(_DIR, "Makefile")]
    src = os.path.join(_DIR, "src")
    if os.path.isdir(src):
        deps += [os.path.join(src, f) for f in os.listdir(src)]
    # A missing dep (deleted/renamed src/*.cc) means the build inputs
    # changed → stale, let make decide; strict < so mtime ties on
    # coarse-granularity filesystems also rebuild rather than silently
    # keeping an outdated .so.
    return all(os.path.exists(d) and os.path.getmtime(d) < so_mtime
               for d in deps)


def _load() -> bool:
    global _lib
    if _lib is not None:
        return True
    if not os.path.exists(_LIB_PATH):
        return False
    lib = ctypes.CDLL(_LIB_PATH)
    lib.jaxmot_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int32)]
    lib.jaxmot_parse_mot_csv.restype = ctypes.c_int64
    lib.jaxmot_parse_mot_csv.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.jaxmot_bgr_to_gray.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.jaxmot_ring_create.restype = ctypes.c_void_p
    lib.jaxmot_ring_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
    lib.jaxmot_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.jaxmot_ring_push.restype = ctypes.c_int32
    lib.jaxmot_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.jaxmot_ring_pop.restype = ctypes.c_int64
    lib.jaxmot_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.jaxmot_ring_size.restype = ctypes.c_int32
    lib.jaxmot_ring_size.argtypes = [ctypes.c_void_p]
    lib.jaxmot_sched_create.restype = ctypes.c_void_p
    lib.jaxmot_sched_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int64]
    lib.jaxmot_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.jaxmot_sched_push.restype = ctypes.c_int32
    lib.jaxmot_sched_push.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64]
    lib.jaxmot_sched_gather.restype = ctypes.c_int32
    lib.jaxmot_sched_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.jaxmot_sched_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return True


def available() -> bool:
    return _lib is not None or _load()


_BIG = 1e9


def assign(cost: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment (native Hungarian); same interface as
    ops.assignment.scipy_assign. Falls back to SciPy when unbuilt."""
    if not available():
        from jaxmot.ops.assignment import scipy_assign
        return scipy_assign(cost, feasible)
    n, m = cost.shape
    c = np.where(feasible, cost, _BIG).astype(np.float64, order="C")
    out = np.empty((n,), np.int32)
    _lib.jaxmot_assign(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m, _BIG,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def parse_mot_csv(path: str) -> np.ndarray:
    """det/gt CSV → [rows, 7] float64 (frame, id, x, y, w, h, score).
    Falls back to numpy.loadtxt when unbuilt."""
    if not available():
        raw = np.loadtxt(path, delimiter=",", ndmin=2)
        out = np.ones((len(raw), 7))
        out[:, : min(7, raw.shape[1])] = raw[:, :7]
        return out
    n = _lib.jaxmot_parse_mot_csv(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot parse {path}")
    out = np.empty((n, 7), np.float64)
    got = _lib.jaxmot_parse_mot_csv(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n)
    return out[:got]


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 BGR → [H, W] uint8 gray (BT.601 fixed point)."""
    if not available():
        b = bgr.astype(np.uint32)
        return ((77 * b[..., 2] + 150 * b[..., 1] + 29 * b[..., 0]) >> 8
                ).astype(np.uint8)
    h, w, _ = bgr.shape
    src = np.ascontiguousarray(bgr)
    out = np.empty((h, w), np.uint8)
    _lib.jaxmot_bgr_to_gray(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h * w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


class FrameRing:
    """SPSC frame ring buffer over the native implementation."""

    def __init__(self, capacity: int, frame_bytes: int):
        if not available():
            raise RuntimeError("libjaxmot.so not built; call ensure_built()")
        self._ptr = _lib.jaxmot_ring_create(capacity, frame_bytes)
        self.frame_bytes = frame_bytes

    def push(self, frame: np.ndarray) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        return bool(_lib.jaxmot_ring_push(
            self._ptr, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.nbytes))

    def pop(self, shape, dtype=np.uint8):
        out = np.empty(shape, dtype)
        got = _lib.jaxmot_ring_pop(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.nbytes)
        if got == 0:
            return None
        if got < 0:
            # The native side returns a flat -1 for a frame larger than
            # the caller's buffer (ingest.cc), not a byte count.
            raise ValueError(
                f"stored ring frame is larger than the pop buffer "
                f"({out.nbytes} bytes) — mismatched frame geometry")
        if got != out.nbytes:
            # A smaller stored frame would leave the np.empty tail
            # uninitialized — same geometry mismatch, other direction.
            raise ValueError(
                f"stored ring frame is {got} bytes but the pop buffer "
                f"expects {out.nbytes} — mismatched frame geometry")
        return out

    def __len__(self):
        return int(_lib.jaxmot_ring_size(self._ptr))

    def __del__(self):
        # Module globals may already be torn down at interpreter exit.
        if getattr(self, "_ptr", None) and _lib is not None:
            _lib.jaxmot_ring_destroy(self._ptr)
            self._ptr = None


class StreamScheduler:
    """Multi-stream batch assembly: N decode threads push into per-stream
    SPSC rings; a single gather() builds the [n_streams, ...] device batch
    with a repeat-last-frame policy for late streams (real-time serving
    never blocks on a slow decoder).  Native-backed when libjaxmot.so is
    built; pure-Python deque fallback otherwise.

    >>> sched = StreamScheduler(8, frame_shape=(1080, 1920), capacity=4)
    >>> sched.push(stream_id, frame)            # from decode threads
    >>> batch, fresh = sched.gather()           # from the device feeder
    >>> sched.stats()                           # drops / repeats / fresh
    """

    def __init__(self, n_streams: int, frame_shape, capacity: int = 4,
                 dtype=np.uint8):
        self.n_streams = n_streams
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.frame_shape)
                               * self.dtype.itemsize)
        self._native = ensure_built()
        if self._native:
            self._ptr = _lib.jaxmot_sched_create(n_streams, capacity,
                                                 self.frame_bytes)
        else:
            import collections
            import threading
            self._rings = [collections.deque(maxlen=capacity)
                           for _ in range(n_streams)]
            self._locks = [threading.Lock() for _ in range(n_streams)]
            self._last = [None] * n_streams
            self._dropped = np.zeros(n_streams, np.int64)
            self._repeated = np.zeros(n_streams, np.int64)
            self._fresh = np.zeros(n_streams, np.int64)
            self._capacity = capacity

    def push(self, stream: int, frame) -> bool:
        buf = np.ascontiguousarray(frame, dtype=self.dtype)
        if buf.nbytes != self.frame_bytes:
            raise ValueError(f"frame is {buf.nbytes} bytes, expected "
                             f"{self.frame_bytes}")
        if not (0 <= stream < self.n_streams):
            # Match the native backend's bounds behavior (scheduler.cc
            # returns 0) instead of raising IndexError only on the
            # Python fallback.
            return False
        if self._native:
            return bool(_lib.jaxmot_sched_push(
                self._ptr, stream,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                buf.nbytes))
        with self._locks[stream]:
            if len(self._rings[stream]) >= self._capacity:
                self._dropped[stream] += 1
                return False
            self._rings[stream].append(buf.copy())
            return True

    def gather(self):
        """Returns (batch [n_streams, *frame_shape], fresh [n_streams]
        bool) or None while some stream has never produced a frame."""
        if self._native:
            out = np.empty((self.n_streams,) + self.frame_shape, self.dtype)
            fresh = np.zeros((self.n_streams,), np.uint8)
            n = _lib.jaxmot_sched_gather(
                self._ptr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                fresh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if n < 0:
                return None
            return out, fresh.astype(bool)
        # Readiness precheck so an incomplete batch consumes nothing
        # (rings only grow from the producer side).
        for i in range(self.n_streams):
            if self._last[i] is None and not self._rings[i]:
                return None
        out = np.empty((self.n_streams,) + self.frame_shape, self.dtype)
        fresh = np.zeros((self.n_streams,), bool)
        for i in range(self.n_streams):
            with self._locks[i]:
                if self._rings[i]:
                    self._last[i] = self._rings[i].popleft()
                    self._fresh[i] += 1
                    fresh[i] = True
                else:
                    self._repeated[i] += 1
            out[i] = self._last[i].reshape(self.frame_shape)
        return out, fresh

    def stats(self) -> dict:
        if self._native:
            dropped = np.zeros(self.n_streams, np.int64)
            repeated = np.zeros(self.n_streams, np.int64)
            fresh = np.zeros(self.n_streams, np.int64)
            p = ctypes.POINTER(ctypes.c_int64)
            _lib.jaxmot_sched_stats(self._ptr,
                                    dropped.ctypes.data_as(p),
                                    repeated.ctypes.data_as(p),
                                    fresh.ctypes.data_as(p))
        else:
            dropped, repeated, fresh = (self._dropped, self._repeated,
                                        self._fresh)
        return {"dropped": dropped.tolist(), "repeated": repeated.tolist(),
                "fresh": fresh.tolist()}

    def __del__(self):
        if (getattr(self, "_native", False) and getattr(self, "_ptr", None)
                and _lib is not None):
            _lib.jaxmot_sched_destroy(self._ptr)
            self._ptr = None
