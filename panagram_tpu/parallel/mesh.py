"""Device mesh helpers.

The engine's distribution model (SURVEY §2.7, §5.8):

* one logical mesh axis, ``shard``, over which BOTH the dictionary (by key
  range — the tensor-parallel analogue of the reference's <=32-genome
  bit-plane partitioning, reference index.py:391-426) AND anchor-sequence
  positions (sequence parallelism — the chunk streaming of cpp/anchor.cpp
  :112-147) are sharded;
* queries are routed between the two shardings with an all_to_all by key
  range; totals/histograms come back via psum.

Multi-process runs pin each process to its own card of its host,
initialize jax.distributed, and use the same mesh over the global device
list.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

DICT_AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            # a silently truncated mesh produces WRONG results downstream
            # (callers decode outputs assuming n_devices shards) — fail
            # loudly instead; on CPU runs the 8-virtual-device env must be
            # in place before the interpreter starts (tests/conftest.py)
            raise ValueError(
                f"make_mesh: {n_devices} devices requested but only "
                f"{len(devices)} visible ({[str(d) for d in devices]}); "
                f"set XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} (before process start) or lower --mesh")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DICT_AXIS,))


def cuda_card_count() -> int | None:
    """Number of CUDA cards this process may use, or None when JAX will
    not run on CUDA: JAX_PLATFORMS names no GPU platform, or the host has
    no CUDA driver.  Asks the driver (which honours CUDA_VISIBLE_DEVICES)
    without starting JAX's backend."""
    import ctypes

    platforms = {p.strip() for p in (jax.config.jax_platforms or "").split(",")
                 if p.strip()}
    if platforms and not platforms & {"cuda", "gpu"}:
        return None
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(n)) != 0:
        return None
    return n.value or None


def local_cards(process_id: int, per_process: int, n_cards: int | None,
                env=None) -> list[int] | None:
    """The `per_process` cards, among this host's `n_cards`, that process
    `process_id` of a multi-process build owns.  A JAX process reserves
    most of every card it sees, so two processes on one host must never
    share one.

    The process's slot on its host is LOCAL_RANK when the launcher sets
    it, else `process_id mod (n_cards // per_process)`: processes numbered
    host by host, as many on each as its cards hold.  When LOCAL_WORLD_SIZE
    (the processes on this host) needs more cards than the host has, the
    run is refused.  None when JAX will not run on CUDA (the CPU backend)."""
    env = os.environ if env is None else env
    if n_cards is None:
        return None
    slots = n_cards // per_process
    local = int(env.get("LOCAL_WORLD_SIZE", 1))
    if local > slots:
        raise RuntimeError(
            f"{local} process(es) of {per_process} card(s) each on this "
            f"host, but it has {n_cards} GPU card(s): each process needs "
            f"cards of its own; run at most {slots} per host")
    rank = int(env.get("LOCAL_RANK", process_id % slots))
    if not 0 <= rank < slots:
        raise RuntimeError(
            f"LOCAL_RANK={rank}, but this host's {n_cards} GPU card(s) hold "
            f"{slots} process(es) of {per_process} card(s)")
    return list(range(rank * per_process, (rank + 1) * per_process))


def pin_process_cards(process_id: int, per_process: int = 1):
    """Make cards local_cards(...) the only ones this process's JAX
    backend sees.  Must run before any backend use."""
    cards = local_cards(process_id, per_process, cuda_card_count())
    if cards is not None:
        jax.config.update("jax_cuda_visible_devices",
                          ",".join(map(str, cards)))
    return cards


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           mesh_devices: int | None = None):
    """Multi-process bring-up: pin each process to cards of its own (one,
    or its `mesh_devices / num_processes` share of a mesh), then start
    jax.distributed.

    jax.distributed only starts when a coordinator address is explicitly
    given: the file-coordinated build DAG (parallel/distributed.py) does
    not need cross-process collectives, and jax.distributed must be
    initialized before any backend use, which a library cannot guarantee.

    After this, ``jax.devices()`` is the GLOBAL device list across all
    processes and ``make_mesh`` spans it — shard_map bodies and their
    collectives (all_to_all / psum) are unchanged; on GPUs they ride
    NCCL, on the CPU test fixture they ride the Gloo backend."""
    if num_processes is None or num_processes <= 1:
        return
    per_process = 1
    if mesh_devices:
        per_process, rem = divmod(mesh_devices, num_processes)
        if rem or not per_process:
            raise ValueError(
                f"--mesh {mesh_devices} over {num_processes} processes: the "
                "mesh must be a whole multiple of the process count")
    pin_process_cards(process_id or 0, per_process)
    if not coordinator:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def sharded_writes_enabled() -> bool:
    """True when a multi-process mesh build should use the per-host
    sharded drain + piece writes (each process expands and BGZF-writes
    only its own devices' bitmap rows; the primary stitches).  Default
    for any multi-process run; PANAGRAM_TPU_SHARD_WRITES=0 restores the
    every-process-writes-everything mirror behaviour."""
    if os.environ.get("PANAGRAM_TPU_SHARD_WRITES", "1") == "0":
        return False
    return jax.process_count() > 1


def assert_lockstep(tag: str, value):
    """Fail LOUDLY when `value` differs across the processes of a
    multi-process mesh build.

    Stage-skip decisions (mtime caching) gate collective work: if one
    process skips a stage another re-runs, their collective call
    sequences diverge and the job dies deep in the transport layer with
    an opaque size-mismatch ("op.preamble.length <= op.nbytes").  This
    turns that into an immediate, actionable error.  It is ITSELF a
    collective — call it unconditionally at the decision point on every
    process.  No-op in single-process runs."""
    if jax.process_count() <= 1:
        return
    import hashlib

    from jax.experimental import multihost_utils

    h = np.frombuffer(
        hashlib.sha256(repr(value).encode()).digest()[:8], np.uint64)
    all_h = np.asarray(
        multihost_utils.process_allgather(h, tiled=True)).reshape(-1)
    if not (all_h == all_h[0]).all():
        raise RuntimeError(
            f"multi-process build desync at '{tag}': processes disagree "
            f"on a cached-stage decision (value here: {value!r}).  All "
            "processes must start from equivalent stage states — use "
            "fresh/equalized output dirs or pass --force on every "
            "process.")


def host_view(x) -> np.ndarray:
    """``np.asarray`` that also works for global (multi-process) arrays.

    Sharded outputs of the mesh engines are only partially addressable
    when processes > 1; gather them with an all_gather collective so every
    process sees the full value (control decisions made from these values
    — overflow retries, prefix sizes — must match across processes or the
    collective programs deadlock, so a full gather is the SAFE primitive;
    per-host shard reads are a later optimization).  NOTE: in
    multi-process mode this is itself a collective — every process must
    call it in the same order."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
