"""Crash-consistent checkpoint store: the port of
``repro.checkpoint.store``, RECIPE's technique as a framework feature.

The store is a Condition-#1 conversion:

* tensor blobs are written copy-on-write into a PM arena (unreachable
  until committed: crash garbage that ``gc`` reclaims);
* the manifest mapping (param-path, shard, step) -> blob pointer is a
  P-CLHT, so every manifest insert is itself a flush-fence-disciplined
  atomic-key commit;
* a checkpoint generation becomes live through ONE 8-byte atomic store
  of the step number into the superblock, after everything it references
  is persisted.

So a crash at any point during ``save`` leaves the previous generation
restorable, with no recovery log and no repair pass.

A tree is a nested dict (lists, tuples and named tuples too) of torch
tensors or numpy arrays.  It is flattened as
``jax.tree_util.tree_flatten_with_path`` flattens it (dict keys sorted)
and each path is spelt as ``jax.tree_util.keystr`` spells it
(``['blocks']['l0']['attn']['wq']``), so a tree saved here writes the
JAX store's manifest keys, blob words and PMem counters.  bf16 tensors
travel as their uint16 bits with the manifest's bf16 flag, as in the JAX
store.  ``restore`` returns CPU tensors, bf16 where the flag is set.
Every leaf is one blob in one arena segment, so a leaf holds at most
``SEG_WORDS - HDR_WORDS`` = 65,528 words (a reference limit: the JAX
store has it too).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import PCLHT, PMem
from ..core.arena import Arena

_M64 = (1 << 64) - 1


def _path_key(path: str, shard: int, step: int) -> int:
    h = 1469598103934665603
    for ch in f"{path}#{shard}".encode():
        h = ((h ^ ch) * 1099511628211) & _M64
    # fold the step in (manifest key is per-generation); keep within
    # int63: PM words are signed 64-bit
    h = ((h ^ step) * 0x9E3779B97F4A7C15) & ((1 << 62) - 1)
    return h | 1  # never NULL


_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64, 3: np.uint16,
           4: np.uint8, 5: np.float64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf in ``tree_flatten_with_path``'s
    order."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree)
                for kv in _flatten(tree[key], f"{path}[{key!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name in tree._fields
                for kv in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, item in enumerate(tree)
                for kv in _flatten(item, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree: Any, leaves: iter) -> Any:
    """``tree``'s structure with its leaves taken in ``_flatten``'s
    order from ``leaves``."""
    if isinstance(tree, dict):
        out = {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
        return {key: out[key] for key in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, name), leaves)
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _host(leaf: Any) -> Tuple[np.ndarray, bool]:
    """A leaf as a numpy array on the host, and whether it is bf16 (then
    its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return arr.view(np.uint16), True
    return arr, False


def _encode(arr: np.ndarray) -> Tuple[int, int, Tuple[int, ...], np.ndarray]:
    code = _DTYPE_CODES[np.dtype(arr.dtype)]
    raw = np.ascontiguousarray(arr).tobytes()
    pad = (-len(raw)) % 8
    words = np.frombuffer(raw + b"\0" * pad, dtype=np.int64)
    return code, len(raw), arr.shape, words


def _decode(code: int, nbytes: int, shape: Tuple[int, ...],
            words: np.ndarray, bf16: bool) -> torch.Tensor:
    raw = words.tobytes()[:nbytes]
    arr = np.frombuffer(raw, dtype=_DTYPES[code]).reshape(shape)
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if bf16 else t


class CheckpointStore:
    """One PM-backed store (per host in a real deployment).  ``device``
    is the manifest P-CLHT's (the card unless the caller asks for the
    CPU); the store itself reads and writes only the PM image."""

    def __init__(self, pmem: Optional[PMem] = None, *, device=None):
        self.pmem = pmem or PMem()
        self.arena = Arena(self.pmem, "ckpt")
        self.manifest = PCLHT(self.pmem, n_buckets=256, name="ckpt.manifest",
                              device=device)
        existing = self.pmem.find("ckpt.super")
        if existing is not None:
            self.super = existing  # attach: restart sees committed gens
        else:
            self.super = self.pmem.alloc("ckpt.super", 8)  # [latest_step+1]
            self.pmem.persist_region(self.super)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _write_blob(self, arr: np.ndarray) -> int:
        code, nbytes, shape, words = _encode(arr)
        hdr = [code, nbytes, len(shape)] + list(shape)
        ptr = self.arena.alloc(len(hdr) + len(words) + 1)
        seg, off = self.arena._locate(ptr)
        self.pmem.store(seg, off, len(hdr))
        self.pmem.store_bulk(seg, off + 1, np.asarray(hdr, np.int64))
        self.pmem.store_bulk(seg, off + 1 + len(hdr), words)
        # persist the blob BEFORE anything references it (CoW rule)
        self.arena.flush_range(ptr, len(hdr) + len(words) + 1)
        self.pmem.fence()
        return ptr

    def _read_blob(self, ptr: int, bf16: bool) -> torch.Tensor:
        seg, off = self.arena._locate(ptr)
        hlen = self.pmem.load(seg, off)
        hdr = self.pmem.load_bulk(seg, off + 1, hlen)
        code, nbytes, ndim = int(hdr[0]), int(hdr[1]), int(hdr[2])
        shape = tuple(int(d) for d in hdr[3:3 + ndim])
        nwords = (nbytes + 7) // 8
        words = self.pmem.load_bulk(seg, off + 1 + hlen, nwords)
        return _decode(code, nbytes, shape, words, bf16)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, shard: int = 0) -> None:
        """Write a checkpoint generation and commit it atomically."""
        with self._lock:
            for path, leaf in _flatten(tree):
                arr, bf16 = _host(leaf)
                ptr = self._write_blob(arr)
                key = _path_key(path, shard, step)
                meta = (ptr << 1) | (1 if bf16 else 0)
                # P-CLHT insert: internally flush+fence disciplined
                self.manifest.insert(key, meta)
            # COMMIT POINT (Condition #1): one atomic superblock store
            self.pmem.store(self.super, 0, step + 1)
            self.pmem.persist(self.super, 0)

    def latest_step(self) -> Optional[int]:
        v = self.pmem.load(self.super, 0)
        return None if v == 0 else v - 1

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                shard: int = 0) -> Any:
        """Rebuild ``tree_like``'s structure from the checkpointed
        arrays (CPU tensors).  No recovery pass: reads after a crash
        return the last committed generation."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no committed checkpoint generation")
        leaves = []
        for path, _ in _flatten(tree_like):
            meta = self.manifest.lookup(_path_key(path, shard, step))
            if meta is None:
                raise KeyError(f"missing {path} @ step {step}")
            leaves.append(self._read_blob(meta >> 1, bool(meta & 1)))
        return _unflatten(tree_like, iter(leaves))

    # ------------------------------------------------------------------
    def save_async(self, step: int, tree: Any) -> threading.Thread:
        """Background save: training continues while the generation is
        written; the commit store publishes it when complete."""
        host = _unflatten(tree, iter(  # snapshot off the device, here
            x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x) for _, x in _flatten(tree)))
        t = threading.Thread(target=self.save, args=(step, host))
        t.start()
        return t

    def gc(self) -> int:
        """Reclaim blobs not referenced by the live generation."""
        live = self.latest_step()

        def walk():
            if live is None:
                return
            for key, meta in self.manifest.items():
                ptr = meta >> 1
                seg, off = self.arena._locate(ptr)
                hlen = self.pmem.load(seg, off)
                hdr = self.pmem.load_bulk(seg, off + 1, hlen)
                nwords = (int(hdr[1]) + 7) // 8
                yield ptr, 1 + hlen + nwords

        return self.arena.gc(walk)


__all__ = ["CheckpointStore"]
