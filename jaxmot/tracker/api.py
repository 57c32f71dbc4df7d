"""Public MOT API — the reference's `mot_init` / `mot_update` surface.

The reference exposes init/update per frame, returning track IDs + boxes
(BASELINE.json north star).  `MultiTracker` is that same surface as a thin
host wrapper: it pads detections to the static capacity, invokes the single
fused device step, and unpacks confirmed tracks.  All tracking state lives
in a device-resident TrackBank pytree — snapshot/restore is `save_state` /
`load_state` (a capability the reference lacks; SURVEY.md §5).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from jaxmot.config import DEFAULT_CONFIG, TrackerConfig
from jaxmot.tracker import step as step_mod
from jaxmot.tracker.bank import TrackBank, empty_bank


def pad_detections(dets, capacity: int, width: int | None = None):
    """[N, 4|5|6] array-like → ([capacity, 5|6], [capacity] valid mask).

    A 6th column is a detector class id (cfg.class_aware); it is kept iff
    the input carries it, so 5-column callers keep their exact traces.
    Pass width=6 to force the class-aware form regardless of the input
    (missing classes pad 0 — the single-class semantics): MultiTracker
    does this under cfg.class_aware so an empty/5-col frame in a 6-col
    stream cannot flip the static detection shape and force a retrace.
    """
    dets = np.asarray(dets, np.float32)
    if dets.size == 0:
        dets = dets.reshape(0, dets.shape[-1] if dets.ndim == 2 else 5)
    if dets.ndim == 1:
        # A bare [cx, cy, w, h(, score)] is one detection — without this
        # the row broadcast below would fabricate 4-5 phantom copies.
        dets = dets.reshape(1, -1)
    n = min(len(dets), capacity)
    if width is None:
        width = 6 if dets.shape[-1] >= 6 else 5
    out = np.zeros((capacity, width), np.float32)
    if dets.shape[-1] == 4:
        out[:n, :4] = dets[:n]
        out[:n, 4] = 1.0
    else:
        w_in = min(dets.shape[-1], width)
        out[:n, :w_in] = dets[:n, :w_in]
    valid = np.zeros((capacity,), bool)
    valid[:n] = True
    return out, valid


class MultiTracker:
    """Detect-track MOT pipeline behind the reference's init/update API.

    >>> mt = MultiTracker()
    >>> mt.init(frame0, dets0)                  # dets: [N, 4|5] cx cy w h (score)
    >>> tracks = mt.update(frame1, dets1)       # [(id, (cx, cy, w, h), score)]
    """

    def __init__(self, cfg: TrackerConfig | None = None):
        self.cfg = cfg or DEFAULT_CONFIG
        # Pin the detection width per config so mixed 5/6-col frames
        # trace as ONE program (width flips would retrace the step).
        self._det_width = 6 if self.cfg.class_aware else 5
        self.bank: TrackBank | None = None
        self.last_output = None

    def init(self, frame, detections):
        dets, valid = pad_detections(detections, self.cfg.max_detections,
                                    width=self._det_width)
        self.bank, out = step_mod.init(
            jnp.asarray(frame), jnp.asarray(dets), jnp.asarray(valid),
            self.cfg)
        self.last_output = out
        return self._unpack(out)

    def update(self, frame, detections=None):
        return self._unpack(self.update_async(frame, detections))

    def update_async(self, frame, detections=None):
        """update() without the synchronous host fetch: dispatches the
        step and returns the device-resident StepOutput immediately.

        The per-frame `update` pays a device→host round trip per call
        (tools/bench_latency.py decomposes it).  A serving loop that
        doesn't need every frame's boxes on host can chain update_async
        calls back-to-back (the bank carry keeps them ordered on device)
        and call `unpack(out)` only on the frames it reports.
        """
        if self.bank is None:
            raise RuntimeError("call init() first")
        if detections is None:
            detections = np.zeros((0, 5), np.float32)
        dets, valid = pad_detections(detections, self.cfg.max_detections,
                                    width=self._det_width)
        self.bank, out = step_mod.step(
            self.bank, jnp.asarray(frame), jnp.asarray(dets),
            jnp.asarray(valid), self.cfg)
        self.last_output = out
        return out

    def unpack(self, out):
        """Fetch + unpack a StepOutput from update_async:
        [(id, (cx, cy, w, h), score)]."""
        return self._unpack(out)

    def _unpack(self, out):
        ids = np.asarray(out.ids)
        boxes = np.asarray(out.boxes)
        scores = np.asarray(out.scores)
        valid = np.asarray(out.valid)
        return [(int(ids[i]), tuple(float(v) for v in boxes[i]),
                 float(scores[i]))
                for i in np.where(valid)[0]]

    # -- observability (SURVEY.md §5) ----------------------------------
    def counters(self) -> dict:
        o = self.last_output
        if o is None:
            return {}
        return {"alive": int(o.n_alive), "births": int(o.n_births),
                "deaths": int(o.n_deaths), "matches": int(o.n_matches),
                "assign_iters": int(o.assign_iters),
                "assign_converged": bool(o.assign_converged)}

    # -- checkpoint / resume (SURVEY.md §5) ----------------------------
    def save_state(self) -> dict:
        import jax
        return {"bank": jax.tree.map(np.asarray, self.bank),
                "cfg": self.cfg}

    def load_state(self, snap: dict) -> None:
        import jax
        self.cfg = snap["cfg"]
        self.bank = jax.tree.map(jnp.asarray, snap["bank"])


def reset(cfg: TrackerConfig | None = None) -> TrackBank:
    """Fresh empty bank (functional API)."""
    return empty_bank(cfg or DEFAULT_CONFIG)
