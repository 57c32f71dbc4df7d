"""Tracker package — public API.

The reference's public surface is `mot_init` / `mot_update` per frame
(SURVEY.md §1 L3); those names are provided here as functional aliases
over the fused step, alongside the object API (api.MultiTracker) and the
sequence API (scan.track_sequence).
"""

from jaxmot.tracker.step import init as mot_init        # noqa: F401
from jaxmot.tracker.step import step as mot_update      # noqa: F401
from jaxmot.tracker.api import MultiTracker             # noqa: F401
from jaxmot.tracker.bank import TrackBank, empty_bank   # noqa: F401
