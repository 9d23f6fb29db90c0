"""Mesh fan-out for sharded point lookups: all S shards in one launch.

``ShardedIndex`` executes general plans as per-shard sub-plans (each
shard's own probe kernels against its own PMem).  For the all-GET hot
path — the YCSB-C chunk — this module answers every shard's queries in
ONE launch of the sorted-run search kernel with a shard axis
(``kernels.scan.scan_window_rows``, ``csrc/scan_window.cu``): every
shard's sorted run is stacked end to end at its own length (no
power-of-two padding), and each query row carries the base offset and
live length of its shard's run.  A window of 1 plus a key-equality
check is a point lookup.

The port of ``repro.distributed.mesh``.  The JAX package runs a jitted
``vmap`` of a lower bound over runs padded to a common power of two,
wrapped in ``shard_map`` when the host has >= S devices.  Here all S
shards live on the index's one device and run in one launch; spreading
them over several cards is not built (``mesh_devices`` reports whether
a host has them).

``ShardedIndex`` calls ``probe_rows`` with the plan's keys already on
the card and their shard ids from ``kernels.partition.shard_partition``:
each row's base and length are gathered there from the runs' starts and
sizes, which ``build_stacked`` uploads once.  ``mesh_lookup`` is the
JAX package's per-shard-lists form of the same lookup.

Keys compare in SIGNED 64-bit order, as in the JAX package, whose
split-half compare (signed high half, XOR-biased low half) is signed
64-bit order too: a query of 2^63 or above (negative as int64) has
lower bound 0 in its shard's run.  Found/value semantics are
bit-identical to ``kernels.scan.sorted_lookup`` (lower bound +
key-equality check).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.readback import to_host
from ..kernels.scan import scan_window_rows


@dataclasses.dataclass
class StackedRuns:
    """Every shard's sorted run on the device, end to end."""

    keys: torch.Tensor   # [sum n] int64 — run s at offsets[s]:offsets[s+1]
    vals: torch.Tensor   # [sum n] int64
    offsets: np.ndarray  # [S + 1] int64 — host copy of the run bounds
    n_shards: int
    starts: torch.Tensor  # [S] int64 on the device: offsets[:-1]
    sizes: torch.Tensor   # [S] int64 on the device: the runs' lengths
    ones: torch.Tensor = dataclasses.field(default=None, repr=False)

    def counts(self, n: int) -> torch.Tensor:
        """[n] int32 ones on the device (a window of 1 a row), kept from
        call to call."""
        if self.ones is None or self.ones.shape[0] < n:
            self.ones = torch.ones(max(n, 1), dtype=torch.int32,
                                   device=self.keys.device)
        return self.ones[:n]

    @property
    def n(self) -> np.ndarray:
        """[S] int64 live entries per shard."""
        return np.diff(self.offsets)


def build_stacked(runs: Sequence[Optional[Tuple[np.ndarray, np.ndarray]]],
                  *, device: torch.device) -> StackedRuns:
    """Stack per-shard sorted (keys, vals) runs (None = empty shard)
    end to end at their own lengths, on ``device``."""
    n_live = [0 if r is None else int(r[0].shape[0]) for r in runs]
    offsets = np.zeros(len(runs) + 1, np.int64)
    np.cumsum(n_live, out=offsets[1:])
    live = [r for r in runs if r is not None]
    keys = np.concatenate([np.asarray(k, np.int64) for k, _ in live]
                          or [np.zeros(0, np.int64)])
    vals = np.concatenate([np.asarray(v, np.int64) for _, v in live]
                          or [np.zeros(0, np.int64)])
    return StackedRuns(keys=torch.from_numpy(keys).to(device),
                       vals=torch.from_numpy(vals).to(device),
                       offsets=offsets, n_shards=len(runs),
                       starts=torch.from_numpy(offsets[:-1]).to(device),
                       sizes=torch.from_numpy(np.diff(offsets)).to(device))


def mesh_devices(n_shards: int) -> bool:
    """True when the host has a CUDA device for each of ``n_shards``
    shards (more than one); false on one card.  Reported only: the
    lookup runs every shard on the stacked runs' one device."""
    return torch.cuda.device_count() >= n_shards > 1


def probe_rows(stacked: StackedRuns, queries: torch.Tensor,
               shard: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe all shards in one launch, on the device: query i searches
    the run of shard ``shard[i]`` (queries [Q] int64, shard [Q] int32 or
    int64, both on the runs' device).  Returns the search's (valid,
    keys, vals), each [Q, 1]: query i is found when valid and its key
    equals the query."""
    base = torch.index_select(stacked.starts, 0, shard)
    length = torch.index_select(stacked.sizes, 0, shard)
    return scan_window_rows(queries, stacked.counts(queries.shape[0]),
                            base, length, stacked.keys, stacked.vals,
                            max_count=1)


def found_values(queries: np.ndarray, valid: np.ndarray, keys: np.ndarray,
                 vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(found [Q] bool, values [Q] int64, 0 where not found) from
    ``probe_rows``'s outputs read back."""
    found = valid.reshape(-1) & (keys.reshape(-1) == queries)
    return found, np.where(found, vals.reshape(-1), 0)


def mesh_lookup(stacked: StackedRuns,
                queries: Sequence[np.ndarray]
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Probe all shards in one launch.  ``queries[s]`` is shard s's
    (possibly empty) int64 query vector; returns per-shard
    (found [Qs] bool, values [Qs] int64), bit-identical to probing each
    shard's sorted run with ``kernels.scan.sorted_lookup``."""
    S = stacked.n_shards
    assert len(queries) == S
    q_len = np.array([int(np.asarray(q).shape[0]) for q in queries],
                     np.int64)
    q = np.concatenate([np.asarray(x, np.int64) for x in queries]
                       or [np.zeros(0, np.int64)])
    dev = stacked.keys.device
    shard = torch.from_numpy(np.repeat(np.arange(S), q_len)).to(dev)
    valid, okeys, ovals = probe_rows(stacked, torch.from_numpy(q).to(dev),
                                     shard)
    okeys, ovals, valid = to_host(okeys, ovals, valid)
    found, vals = found_values(q, valid, okeys, ovals)
    bounds = np.concatenate([[0], np.cumsum(q_len)])
    return [(found[bounds[s]:bounds[s + 1]], vals[bounds[s]:bounds[s + 1]])
            for s in range(S)]


__all__ = ["StackedRuns", "build_stacked", "found_values", "mesh_devices",
           "mesh_lookup", "probe_rows"]
