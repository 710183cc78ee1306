"""Test configuration: force an 8-device virtual CPU mesh so multi-device
sharding paths are exercised without accelerator hardware (SURVEY §4
implication c: the 'fake backend' the reference lacks)."""

import os
import tempfile

# Force CPU even on a machine with a GPU: the tests check results, and the
# card belongs to chip_smoke.py's single process.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: the suite is XLA-compile-bound (every test
# process re-compiles the same programs); cache hits cut reruns severalfold.
# It lives outside the checkout, so the tree stays small.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(tempfile.gettempdir(),
                                   "panagram_jax_cache_tests"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def random_seq(rng, n, n_frac=0.0):
    bases = np.array(list("ACGT"))
    seq = rng.choice(bases, size=n)
    if n_frac > 0:
        mask = rng.random(n) < n_frac
        seq[mask] = "N"
    return "".join(seq)
