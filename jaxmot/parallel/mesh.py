"""Device mesh construction for multi-stream serving and detector training.

The reference is a single-process pipeline with no distributed backend
(SURVEY.md §2 "Parallelism strategies" / "Distributed comm backend" — both
absent).  The parallel axes of this domain are:

  * "stream" — independent video streams, one tracker bank per shard
    (the data parallelism of serving; BASELINE configs[4]: 8 concurrent
    1080p streams, e.g. 2 per card on four GPUs).
  * "batch"  — detector data parallelism for training (grads psum over
    the mesh).

Both meshes are 1-D over jax.devices(): the cards of one host are joined
all to all (NVLink), so no device order is better than another and XLA
hands the few collectives (the shared detector's all-gather, the gradient
all-reduce) to NCCL.  Multi-host: call jax.distributed.initialize() with
its coordinator address, process count and id before building the mesh,
and the same code spans hosts (SURVEY.md §5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stream_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the "stream" axis (serving)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("stream",))


def batch_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the "batch" axis (detector training DP)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("batch",))


def shard_leading(mesh: Mesh, axis: str):
    """NamedSharding that splits an array's leading dim over `axis`."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
