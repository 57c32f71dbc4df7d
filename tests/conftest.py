"""Test harness: force CPU JAX with 8 virtual devices (SURVEY.md §4.4).

This is the JAX-idiomatic "fake backend": all jitted code must run on the
CPU, and multi-device stream sharding is exercised on a virtual 8-device
host mesh — no accelerator required.  Environment variables must be set
before jax imports.  The on-card checks live in chip_smoke.py.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
