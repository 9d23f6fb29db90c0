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

from ..kernels.scan import scan_window_rows


@dataclasses.dataclass
class StackedRuns:
    """Every shard's sorted run on the device, end to end."""

    keys: torch.Tensor   # [sum n] int64 — run s at offsets[s]:offsets[s+1]
    vals: torch.Tensor   # [sum n] int64
    offsets: np.ndarray  # [S + 1] int64 — host copy of the run bounds
    n_shards: int

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
                       offsets=offsets, n_shards=len(runs))


def mesh_devices(n_shards: int) -> bool:
    """True when the host has a CUDA device for each of ``n_shards``
    shards (more than one); false on one card.  Reported only: the
    lookup runs every shard on the stacked runs' one device."""
    return torch.cuda.device_count() >= n_shards > 1


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
    shard = np.repeat(np.arange(S), q_len)
    dev = stacked.keys.device
    qt = torch.from_numpy(q).to(dev)
    base = torch.from_numpy(stacked.offsets[:-1][shard]).to(dev)
    length = torch.from_numpy(stacked.n[shard]).to(dev)
    ones = torch.ones(q.shape[0], dtype=torch.int32, device=dev)
    valid, okeys, ovals = scan_window_rows(qt, ones, base, length,
                                           stacked.keys, stacked.vals,
                                           max_count=1)
    found_t = valid[:, 0] & (okeys[:, 0] == qt)
    vals_t = torch.where(found_t, ovals[:, 0], 0)
    found, vals = found_t.cpu().numpy(), vals_t.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(q_len)])
    return [(found[bounds[s]:bounds[s + 1]], vals[bounds[s]:bounds[s + 1]])
            for s in range(S)]


__all__ = ["StackedRuns", "build_stacked", "mesh_devices", "mesh_lookup"]
