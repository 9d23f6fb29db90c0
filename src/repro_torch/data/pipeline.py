"""Deterministic, exactly-resumable data pipeline: the port of
``repro.data.pipeline``, over the port's ``PCLHT`` and ``PMem`` (the
JAX module imports no JAX; this is its copy).  The same config and seed
give the JAX package's batches bit for bit, as numpy int32 arrays, and
the same PM words and counters.

The cursor — (epoch, step) — is committed after every optimizer step
with the Condition-#1 discipline: an audit entry is inserted into a
P-CLHT ledger (itself flush/fence-disciplined), then the live cursor is
published by ONE 8-byte atomic store into a superblock word.  Restart
resumes at the exact batch boundary: no repeated or skipped examples
(the usual after-crash data-accounting bug class in ad-hoc trainers).

Synthetic corpus: documents of zipf-ish token ids, packed into
fixed-length sequences; global order is a seeded permutation per epoch;
each data-parallel rank reads a disjoint stripe.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..core import PCLHT, PMem

AUDIT_BASE = 1 << 40


def _pack(epoch: int, step: int) -> int:
    return (epoch << 24) | step


def _unpack(v: int):
    return v >> 24, v & ((1 << 24) - 1)


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_docs: int = 4096
    mean_doc_len: int = 512
    seed: int = 1234


class TokenPipeline:
    def __init__(self, cfg: DataConfig, *, rank: int = 0, world: int = 1,
                 pmem: Optional[PMem] = None, device=None):
        assert cfg.global_batch % world == 0
        self.cfg = cfg
        self.rank, self.world = rank, world
        self.local_batch = cfg.global_batch // world
        self.pmem = pmem or PMem()
        # the ledger P-CLHT's device: the card unless the caller asks for
        # the CPU (the pipeline reads and writes only the PM image)
        self.ledger = PCLHT(self.pmem, n_buckets=32, name="data.ledger",
                            device=device)
        existing = self.pmem.find("data.super")
        self.super = existing or self.pmem.alloc("data.super", 8)
        # word 0: packed cursor + 1; word 1: shuffle seed
        if self.pmem.load(self.super, 1) == 0:
            self.pmem.store(self.super, 1, cfg.seed)
            self.pmem.persist_region(self.super)
        self._materialize()

    # ------------------------------------------------------------------
    def _materialize(self) -> None:
        """Build the packed token stream for the current seed (pure
        function of the config — no state to checkpoint)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        lens = rng.geometric(1.0 / cfg.mean_doc_len, size=cfg.n_docs)
        toks = []
        for i, L in enumerate(lens):
            doc = (rng.zipf(1.3, size=int(L)) + i) % (cfg.vocab - 2) + 1
            toks.append(doc.astype(np.int32))
            toks.append(np.asarray([cfg.vocab - 1], np.int32))  # EOD
        stream = np.concatenate(toks)
        n_seq = len(stream) // (cfg.seq_len + 1)
        self.packed = stream[:n_seq * (cfg.seq_len + 1)].reshape(
            n_seq, cfg.seq_len + 1)
        self.n_seq = n_seq
        self.steps_per_epoch = n_seq // cfg.global_batch

    def _perm(self, epoch: int) -> np.ndarray:
        seed = self.pmem.load(self.super, 1)
        return np.random.default_rng((seed, epoch)).permutation(self.n_seq)

    # ------------------------------------------------------------------
    @property
    def cursor(self) -> Tuple[int, int]:
        v = self.pmem.load(self.super, 0)
        return _unpack(v - 1) if v else (0, 0)

    @property
    def global_step(self) -> int:
        epoch, step = self.cursor
        return epoch * self.steps_per_epoch + step

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The batch at the current cursor (NOT yet committed)."""
        epoch, step = self.cursor
        if step >= self.steps_per_epoch:
            epoch, step = epoch + 1, 0
        perm = self._perm(epoch)
        start = step * self.cfg.global_batch
        idx = perm[start + self.rank * self.local_batch:
                   start + (self.rank + 1) * self.local_batch]
        seqs = self.packed[idx]
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def commit(self) -> None:
        """Advance the cursor — call AFTER the optimizer step commits.
        Audit entry first (unreachable state, CoW rule), then ONE atomic
        superblock store publishes the new cursor (Condition #1)."""
        epoch, step = self.cursor
        step += 1
        if step >= self.steps_per_epoch:
            epoch, step = epoch + 1, 0
        packed = _pack(epoch, step)
        self.ledger.insert(AUDIT_BASE + epoch * self.steps_per_epoch + step,
                           packed + 1)
        self.pmem.store(self.super, 0, packed + 1)
        self.pmem.persist(self.super, 0)

    def recover(self) -> None:
        """Post-crash: nothing to repair — the cursor word is either the
        old or the new value (RECIPE Condition #1); stranded audit
        entries are harmless (GC'able)."""
