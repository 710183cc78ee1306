#!/usr/bin/env python
"""Ablation of the RLE/palette tail's primitive costs at chunk scale —
which of change-flags / cumulative scans / compaction scatters / palette
sorts actually costs time on hardware (every stage is measured as a DELTA
against a baseline program that only reduces the input, so per-call
dispatch latency cancels)."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from panagram_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def timed(label, fn, reps=4):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{label:36s} {best*1e3:9.1f} ms")
    return best


def main():
    import panagram_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    P = 1 << 22
    PW = 1 << 19
    print(f"devices={jax.devices()} P=2^22 pal_work=2^19")
    rng = np.random.default_rng(0)
    # run structure resembling the bench: ~8% change density
    rows_np = np.repeat(
        rng.integers(0, 1 << 31, P // 13 + 1, dtype=np.uint32), 13)[:P]
    rows = jax.device_put(jnp.asarray(rows_np[:, None]))

    @jax.jit
    def base(r):
        return r.sum()

    t0 = timed("baseline (reduce only)", lambda: np.asarray(base(rows)))

    @jax.jit
    def flags(r):
        change0 = jnp.concatenate([
            jnp.ones(1, bool), jnp.any(r[1:] != r[:-1], axis=1)])
        return change0.sum()

    timed("+ change flags", lambda: np.asarray(flags(rows)))

    @jax.jit
    def scans(r):
        change0 = jnp.concatenate([
            jnp.ones(1, bool), jnp.any(r[1:] != r[:-1], axis=1)])
        iota = jnp.arange(r.shape[0], dtype=jnp.int32)
        last0 = jax.lax.cummax(jnp.where(change0, iota, -1))
        dist = iota - last0
        change = change0 | ((dist > 0) & (dist % 255 == 0))
        pos = jnp.cumsum(change.astype(jnp.int32)) - 1
        lastrun = jax.lax.cummax(jnp.where(change, iota, -1))
        return pos[-1] + lastrun[-1]

    timed("+ scans (2 cummax + cumsum)", lambda: np.asarray(scans(rows)))

    @jax.jit
    def scat_u8(r):
        change0 = jnp.concatenate([
            jnp.ones(1, bool), jnp.any(r[1:] != r[:-1], axis=1)])
        iota = jnp.arange(r.shape[0], dtype=jnp.int32)
        pos = jnp.cumsum(change0.astype(jnp.int32)) - 1
        slots = jnp.where(change0 & (pos < P), pos, P)
        out = jnp.zeros(P + 1, jnp.uint8).at[slots].set(
            (iota & 0xFF).astype(jnp.uint8), mode="drop")
        return out.sum()

    timed("+ u8 compaction scatter (4M)", lambda: np.asarray(scat_u8(rows)))

    @jax.jit
    def scat_u32(r):
        change0 = jnp.concatenate([
            jnp.ones(1, bool), jnp.any(r[1:] != r[:-1], axis=1)])
        pos = jnp.cumsum(change0.astype(jnp.int32)) - 1
        slots = jnp.where(change0 & (pos < PW), pos, PW)
        out = jnp.zeros((PW + 1, 1), jnp.uint32).at[slots].set(
            r, mode="drop")
        return out.sum()

    timed("+ u32 rmask scatter (4M->512k)",
          lambda: np.asarray(scat_u32(rows)))

    pm = jax.device_put(jnp.asarray(
        rng.integers(0, 1 << 31, PW + 1, dtype=np.uint32)))

    @jax.jit
    def pal_sorts(v):
        io = jnp.arange(v.shape[0], dtype=jnp.int32)
        s = jax.lax.sort((v, io), num_keys=1)
        inv = jax.lax.sort((s[1], s[0].astype(jnp.int32)), num_keys=1)
        return inv[1].sum()

    timed("palette sorts (2 x 512k)", lambda: np.asarray(pal_sorts(pm)))

    @jax.jit
    def concat3(r):
        a = (r[:, 0] & 0xFF).astype(jnp.uint8)
        data = jnp.stack([a, a, a], axis=1)
        return data.sum()

    timed("+ [P,3] stack", lambda: np.asarray(concat3(rows)))
    print(f"(baseline {t0*1e3:.1f} ms is dispatch+reduce; deltas above it "
          "are the real costs)")


if __name__ == "__main__":
    main()
