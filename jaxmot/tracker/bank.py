"""The track bank: fixed-capacity SoA state for the whole MOT pipeline.

Dense replacement for the reference's per-track C structs + pointer
list (SURVEY.md §2 row "track / multitracker"): every per-track field is one
dense array over a static capacity T, with an integer lifecycle state per
slot.  The entire bank is a pytree — snapshotable for checkpoint/resume
(SURVEY.md §5) and shardable across a stream mesh.

Slot lifecycle (SORT-style):  EMPTY → TENTATIVE → CONFIRMED → EMPTY.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.ops import cfloat
from jaxmot.ops import kcf as kcf_ops

EMPTY = 0
TENTATIVE = 1
CONFIRMED = 2


class TrackBank(NamedTuple):
    """Dense per-slot state; [T] leading axis everywhere."""

    kf_mean: jnp.ndarray      # [T, 8]  cx cy w h + velocities
    kf_cov: jnp.ndarray       # [T, 8, 8]
    kcf: kcf_ops.KCFModel     # spectra [T, C, S, Sf], [T, S, Sf]
    ids: jnp.ndarray          # [T] int32, -1 for empty slots
    state: jnp.ndarray        # [T] int32 lifecycle
    hits: jnp.ndarray         # [T] int32 matched-detection count
    time_since_update: jnp.ndarray  # [T] int32 frames since last detection
    age: jnp.ndarray          # [T] int32 frames since birth
    score: jnp.ndarray        # [T] float32 last confidence
    cls: jnp.ndarray          # [T] int32 detector class the track was born
                              # with (0 when detections carry no classes;
                              # -1 for empty slots)
    auction_prices: jnp.ndarray  # [max(T, D)] float32 — carried column
                              # prices that warm-start the next frame's
                              # auction (ops/assignment.auction_assign_warm);
                              # zeros when cfg.auction_warm_start is off.
    auction_col_of: jnp.ndarray  # [max(T, D)] int32 — the carried
                              # matching (padded row -> column, -1 = none)
                              # that pairs with auction_prices; the
                              # dynamic auction re-validates it against
                              # eps-CS each frame.
    next_id: jnp.ndarray      # [] int32
    frame_idx: jnp.ndarray    # [] int32

    @property
    def alive(self) -> jnp.ndarray:
        return self.state > EMPTY

    @property
    def confirmed(self) -> jnp.ndarray:
        return self.state == CONFIRMED

    @property
    def boxes(self) -> jnp.ndarray:
        return self.kf_mean[:, :4]


def empty_bank(cfg: TrackerConfig) -> TrackBank:
    t = cfg.max_tracks
    s = cfg.kcf.feature_size
    sf = cfg.kcf.spectrum_width
    c = cfg.kcf.num_channels
    return TrackBank(
        kf_mean=jnp.zeros((t, 8), jnp.float32),
        kf_cov=jnp.tile(jnp.eye(8, dtype=jnp.float32)[None], (t, 1, 1)),
        kcf=kcf_ops.KCFModel(
            xf=cfloat.zeros((t, c, s, sf)),
            alphaf=cfloat.zeros((t, s, sf))),
        ids=jnp.full((t,), -1, jnp.int32),
        state=jnp.zeros((t,), jnp.int32),
        hits=jnp.zeros((t,), jnp.int32),
        time_since_update=jnp.zeros((t,), jnp.int32),
        age=jnp.zeros((t,), jnp.int32),
        score=jnp.zeros((t,), jnp.float32),
        cls=jnp.full((t,), -1, jnp.int32),
        auction_prices=jnp.zeros(
            (max(t, cfg.max_detections),), jnp.float32),
        auction_col_of=jnp.full(
            (max(t, cfg.max_detections),), -1, jnp.int32),
        next_id=jnp.int32(0),
        frame_idx=jnp.int32(0),
    )
