"""Per-stream failure supervision (SURVEY.md §5 "Failure detection /
elastic recovery / fault injection").

The reference has none — a crashed tracker is a crashed demo.  Here each
stream's tracker state is one pytree, so supervision is cheap:

  * periodic snapshots of the TrackBank (device → host pytree copy),
  * NaN / explosion detection on step outputs,
  * automatic rollback-and-reinit when a step raises or produces garbage.

Fault injection for tests lives in data/synthetic.py (dropped frames /
detections / false positives).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from jaxmot.config import TrackerConfig
from jaxmot.tracker import bank as bank_mod
from jaxmot.tracker import step as step_mod


def output_healthy(out, frame_hw) -> bool:
    """Cheap per-frame health check on a StepOutput."""
    boxes = np.asarray(out.boxes)
    if not np.isfinite(boxes).all():
        return False
    h, w = frame_hw
    valid = np.asarray(out.valid)
    if valid.any():
        b = boxes[valid]
        if (np.abs(b[:, 0]) > 10 * w).any() or (np.abs(b[:, 1]) > 10 * h).any():
            return False
    return True


class StreamSupervisor:
    """Wraps the per-frame step with snapshot / health-check / recover.

    >>> sup = StreamSupervisor(cfg)
    >>> out = sup.step(frame, dets, det_valid)   # recovers from stream
    ...                                           # corruption
    >>> sup.failures                              # observability counter

    The first call compiles the step for this config; an exception there
    (a lowering or compile failure) is a program fault that no rollback
    can repair, so it propagates.  Later exceptions and unhealthy outputs
    are runtime faults and trigger recovery.
    """

    def __init__(self, cfg: TrackerConfig, snapshot_every: int = 30):
        self.cfg = cfg
        self.snapshot_every = snapshot_every
        self.bank = bank_mod.empty_bank(cfg)
        self._snapshot = jax.tree.map(np.asarray, self.bank)
        self._compiled = False
        self.frame_idx = 0
        self.failures = 0
        self.last_recovery_frame = -1

    def _snap(self):
        self._snapshot = jax.tree.map(np.asarray, self.bank)

    def _restore(self):
        self.bank = jax.tree.map(jnp.asarray, self._snapshot)

    def _healthy(self, out) -> bool:
        return output_healthy(out, (self.cfg.frame_height,
                                    self.cfg.frame_width))

    def step(self, frame, dets, det_valid):
        args = (jnp.asarray(frame), jnp.asarray(dets),
                jnp.asarray(det_valid))
        if not self._compiled:
            step_mod.step.lower(self.bank, *args, self.cfg).compile()
            self._compiled = True
        try:
            new_bank, out = step_mod.step(self.bank, *args, self.cfg)
            if not self._healthy(out):
                raise FloatingPointError("unhealthy tracker output")
            self.bank = new_bank
        except Exception:
            # Roll back to the last good snapshot and re-seed from the
            # current detections (tracker state is ephemeral by design —
            # recovery cost is one frame of tentative tracks).  One failed
            # frame event = ONE failure count, regardless of how many
            # recovery stages it takes — the counter an operator alarms on
            # means "frames affected", not "recovery attempts".
            self.failures += 1
            self.last_recovery_frame = self.frame_idx
            self._restore()
            try:
                new_bank, out = step_mod.step(self.bank, *args, self.cfg)
                healthy = self._healthy(out)
            except Exception:
                new_bank, out, healthy = None, None, False
            if healthy:
                self.bank = new_bank
            else:
                # The fault is in the inputs (e.g. a NaN frame), not the
                # state: keep the restored snapshot and skip this frame
                # with an all-empty input.  Persisting the corrupt retry
                # bank would defeat the health gate.  If even this step
                # fails, the device is at fault and the error propagates.
                self.bank, out = step_mod.step(
                    self.bank, *(jnp.zeros_like(a) for a in args), self.cfg)
        self.frame_idx += 1
        if self.frame_idx % self.snapshot_every == 0:
            self._snap()
        return out
