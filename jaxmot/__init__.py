"""jaxmot: multiple-object tracking in JAX.

Public surface (the reference's init/update API and its configuration):

>>> from jaxmot import MultiTracker, TrackerConfig
>>> mt = MultiTracker(TrackerConfig())
>>> mt.init(frame0, dets0)
>>> tracks = mt.update(frame1, dets1)

Heavy imports (jax et al.) happen lazily on attribute access so
`import jaxmot` stays cheap for tooling.
"""

__version__ = "0.2.0"

_EXPORTS = {
    "MultiTracker": ("jaxmot.tracker.api", "MultiTracker"),
    "KCFTracker": ("jaxmot.tracker.kcf_bank", "KCFTracker"),
    "YoloDetector": ("jaxmot.models.detector", "YoloDetector"),
    "TrackerConfig": ("jaxmot.config", "TrackerConfig"),
    "KCFConfig": ("jaxmot.config", "KCFConfig"),
    "KalmanConfig": ("jaxmot.config", "KalmanConfig"),
    "YoloSpec": ("jaxmot.models.yolo", "YoloSpec"),
    "dets_with_classes": ("jaxmot.models.detector", "dets_with_classes"),
}

__all__ = list(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'jaxmot' has no attribute {name!r}")
