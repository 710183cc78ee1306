"""Multi-host index build: genomes data-parallel across processes.

The reference scales its build with Snakemake job parallelism on one host
(SURVEY §2.7 P1).  Here the same DAG runs one process per card (each pinned
to its own card, parallel/mesh.py): every process counts the genomes it owns (round-robin by genome id)
and anchors its share of anchor genomes; coordination is file-based on the
shared index directory — the same "resume = skip completed artifacts"
property as the reference's rule DAG (SURVEY §5.3), so a lost host is
recovered by rerunning it.

`jax.distributed` initialization is optional and only needed when the
collective-based sharded engine (parallel/shard.py) spans hosts; the
file-coordinated DAG itself requires only a shared filesystem.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger(__name__)


def _wait_for(paths, timeout=86400, poll=2.0):
    t0 = time.time()
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {missing[:3]} ...")
        time.sleep(poll)


def _done_marker(prefix, stage, pid):
    return os.path.join(prefix, "logs", f".done.{stage}.{pid}")


def _clear_done_markers(prefix, pid):
    """Remove THIS process's stale markers from a previous (crashed or
    forced) run before any barrier can observe them; each process clears
    only its own so a peer's live marker is never lost."""
    logdir = os.path.join(prefix, "logs")
    for stage in ("count", "anchor"):
        try:
            os.remove(_done_marker(prefix, stage, pid))
        except FileNotFoundError:
            pass


def _mark_done(prefix, stage, pid):
    os.makedirs(os.path.join(prefix, "logs"), exist_ok=True)
    with open(_done_marker(prefix, stage, pid), "w") as f:
        f.write(str(time.time()))


def build_index_distributed(samples_or_dir, prefix=None, num_processes=1,
                            process_id=0, coordinator=None, force=False,
                            device_dict=False, **params):
    """Distributed build: call once per process/host with a distinct
    process_id over a shared filesystem."""
    from ..config import config_path, samples_path
    from ..index import Index
    from ..pipeline import (
        anchor_stage,
        build_dict_stage,
        count_genome,
        dist_stage,
    )
    from .mesh import initialize_distributed

    initialize_distributed(coordinator, num_processes, process_id)

    if process_id == 0:
        index = Index(samples_or_dir, mode="w", prefix=prefix, **params)
        _clear_done_markers(index.prefix, process_id)
    else:
        # wait for process 0 to initialize config + samples
        target = prefix or samples_or_dir
        _wait_for([config_path(target), samples_path(target)])
        index = Index(target, mode="w")
        _clear_done_markers(index.prefix, process_id)

    # ---- counting: genomes round-robin by id ----
    mine = [n for i, n in enumerate(index.genome_names)
            if i % num_processes == process_id
            and index.genomes[n].fasta is not None]
    for name in mine:
        count_genome(index, name, force=force)
        logger.info(f"[p{process_id}] counted {name}")
    _mark_done(index.prefix, "count", process_id)

    # ---- dictionary: built once by process 0 after all counts land ----
    all_sets = [index.kmer_set_fname(n) for n in index.genome_names
                if index.genomes[n].fasta is not None]
    if process_id == 0:
        _wait_for([_done_marker(index.prefix, "count", p)
                   for p in range(num_processes)])
        _wait_for(all_sets)
        build_dict_stage(index, force=force)
    else:
        _wait_for([index.dict_fname])

    # ---- anchoring: anchor genomes round-robin ----
    my_anchors = [a for i, a in enumerate(index.anchor_genomes)
                  if i % num_processes == process_id]
    for name in my_anchors:
        anchor_stage(index, name, force=force)
        logger.info(f"[p{process_id}] anchored {name}")
    _mark_done(index.prefix, "anchor", process_id)

    if process_id == 0:
        _wait_for([_done_marker(index.prefix, "anchor", p)
                   for p in range(num_processes)])
        dist_stage(index, force=force)
        return Index(index.prefix)
    return None
