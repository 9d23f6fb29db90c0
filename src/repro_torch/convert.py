"""Carry a persistence domain across from plain arrays.

The state of this system is its PM image, so carrying a table over
from another process or package is what carrying weights over is for a
model: ``pmem_from_arrays`` builds a port ``PMem`` from plain numpy
arrays, and ``PCLHT(pmem, name=...)`` then attaches to the table it
holds through the index's ordinary restart path.  The tests build the
arrays from the JAX package's ``PMem`` regions and hold both packages
to the same table.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np

from .core.pmem import WORDS_PER_LINE, OpCounters, PMem, Region


def pmem_from_arrays(regions: Iterable[Mapping], next_rid: int, *,
                     counters: Optional[Mapping[str, int]] = None,
                     seed: int = 0) -> PMem:
    """A ``PMem`` holding the given regions.

    Each region is a mapping with ``rid``, ``name``, ``cache`` and
    ``pm`` (int64 word arrays of one length) and ``stores`` (the
    region's store count, which the foreign-writer check reads).
    ``next_rid`` is the id the next allocation takes; ``counters``
    holds the ``OpCounters`` fields; ``seed`` seeds the eviction RNG.
    A line whose cache and pm words differ is dirty (written, not yet
    flushed); every other line is clean, as after any completed op."""
    pmem = PMem(seed=seed)
    for spec in regions:
        cache = np.array(spec["cache"], dtype=np.int64)
        pm = np.array(spec["pm"], dtype=np.int64)
        if cache.ndim != 1 or cache.shape != pm.shape:
            raise ValueError(f"region {spec['name']!r}: cache and pm must "
                             f"be 1-D arrays of one length")
        rid = int(spec["rid"])
        if rid in pmem.regions or rid >= next_rid:
            raise ValueError(f"region id {rid} is repeated or not below "
                             f"next_rid={next_rid}")
        region = Region(str(spec["name"]), rid, cache.shape[0])
        region.cache, region.pm = cache, pm
        region.stores = int(spec["stores"])
        differs = np.nonzero(cache != pm)[0] // WORDS_PER_LINE
        region.dirty = set(np.unique(differs).tolist())
        pmem.regions[rid] = region
        pmem.alloc_log.append(rid)
    pmem._next_rid = int(next_rid)
    if counters is not None:
        pmem.counters = OpCounters(**{k: int(v) for k, v in counters.items()})
    return pmem


__all__ = ["pmem_from_arrays"]
