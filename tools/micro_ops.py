#!/usr/bin/env python
"""Micro-benchmarks of the primitive ops the RLE/palette tails are built
from (sort vs scatter vs gather at the relevant sizes) — used to choose
between sort-based and scatter-based inverse permutations on the card."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from panagram_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def timed(label, fn, reps=3):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{label:40s} {best*1e3:9.2f} ms")
    return best


def main():
    import panagram_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    print(f"devices={jax.devices()}")
    rng = np.random.default_rng(0)

    for n_log2 in (19, 20):
        n = 1 << n_log2
        perm = rng.permutation(n).astype(np.int32)
        vals = rng.integers(0, 1 << 31, n, dtype=np.int32)
        pd = jax.device_put(jnp.asarray(perm))
        vd = jax.device_put(jnp.asarray(vals))

        @jax.jit
        def inv_sort(p, v):
            s = jax.lax.sort((p, v), num_keys=1)
            return s[1].sum()

        @jax.jit
        def inv_scatter(p, v):
            out = jnp.zeros(p.shape[0], jnp.int32).at[p].set(v, mode="drop")
            return out.sum()

        @jax.jit
        def inv_gather(p, v):
            return v[p].sum()

        @jax.jit
        def grp_sort(p, v):
            # the palette grouping shape: u32 key + i32 payload
            s = jax.lax.sort((v.astype(jnp.uint32), p), num_keys=1)
            return s[1].sum()

        timed(f"2^{n_log2} inverse perm: sort(i32,i32)",
              lambda: np.asarray(inv_sort(pd, vd)))
        timed(f"2^{n_log2} inverse perm: scatter",
              lambda: np.asarray(inv_scatter(pd, vd)))
        timed(f"2^{n_log2} inverse perm: gather",
              lambda: np.asarray(inv_gather(pd, vd)))
        timed(f"2^{n_log2} group sort (u32,i32)",
              lambda: np.asarray(grp_sort(pd, vd)))


if __name__ == "__main__":
    main()
