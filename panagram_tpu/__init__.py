"""panagram_tpu — an accelerator pan-genome k-mer engine.

A from-scratch reimplementation of the capabilities of Panagram (an
alignment-free pan-genome indexer/browser) in JAX:

* canonical 2-bit k-mer extraction, counting, and the pan-genome
  presence-mask dictionary run on-device (JAX/XLA),
* the anchoring step (position -> pan-genome presence bitvector) is a
  streamed lookup + popcount + histogram pipeline,
* multi-chip scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with XLA
  collectives (hash-sharded dictionary, psum'd histograms),
* the on-disk index format is byte-compatible with the reference
  (BGZF bitmaps + .gzi, chrs.tsv, bitsum.bins.tsv, total_paircounts.csv,
  tabix gene/anno BEDs; see reference panagram/index.py:468-554).

The engine uses 64-bit packed k-mer keys (k <= 32); x64 mode is enabled
at import so u64 arrays exist on all backends.
"""

import jax

jax.config.update("jax_enable_x64", True)

from .__about__ import __version__  # noqa: E402
from .index import Index  # noqa: E402

__all__ = ["Index", "__version__"]
