"""The 32-bit tag probe kernels' wrappers (``csrc/clht_probe.cu``).

``clht_probe`` is the port of the JAX package's
``kernels/clht_probe/kernel.py`` ``clht_probe``: int32 queries [Q]
against their pre-gathered int32 windows [Q, W], returning whether each
query hit and the first hit's value (0 where none did).  The Pallas
kernel asserts Q % 256 == 0; here Q takes any value.  ``tag_probe`` is
the whole tag lookup in one launch, from the chained table itself: what
``ops.tag_lookup`` computed as ``tag_windows`` followed by
``clht_probe``, reading the table's three tensors as they are.  On
CUDA tensors each launches its kernel on the current stream, or raises;
on CPU tensors each runs its plain version (``ref.probe_plain``,
``ref.tag_probe_plain``).  Nothing else selects between the two.

``LAUNCHES`` counts kernel launches; a call on CPU tensors launches
nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import SLOTS, probe_plain, tag_probe_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"clht_probe": 0, "tag_probe": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("clht_probe")
    lib.clht_probe.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    lib.clht_probe.restype = _I
    lib.tag_probe.argtypes = [_P] * 4 + [_I, ctypes.c_uint] + [_P] * 3
    lib.tag_probe.restype = _I
    lib.clht_probe_error_string.argtypes = [_I]
    lib.clht_probe_error_string.restype = ctypes.c_char_p
    return lib


def clht_probe(queries: torch.Tensor, bucket_keys: torch.Tensor,
               bucket_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries: [Q] int32; bucket_keys, bucket_vals: [Q, W] int32.
    Returns (found [Q] bool, values [Q] int32)."""
    if queries.dim() != 1 or bucket_keys.dim() != 2 or \
            bucket_keys.shape != bucket_vals.shape or \
            bucket_keys.shape[0] != queries.shape[0]:
        raise ValueError(f"queries must be [Q] and the windows [Q, W] "
                         f"alike, got {tuple(queries.shape)}, "
                         f"{tuple(bucket_keys.shape)} and "
                         f"{tuple(bucket_vals.shape)}")
    for name, t in (("queries", queries), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
    dev = queries.device
    if dev.type == "cpu":
        return probe_plain(queries, bucket_keys, bucket_vals)
    if dev.type != "cuda":
        raise ValueError(f"clht_probe takes CUDA or CPU tensors, not {dev}")
    for name, t in (("queries", queries), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_q, width = bucket_keys.shape
    found = torch.empty(n_q, dtype=torch.bool, device=dev)
    values = torch.empty(n_q, dtype=torch.int32, device=dev)
    if n_q == 0:
        return found, values
    if width == 0:
        return found.zero_(), values.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.clht_probe(queries.data_ptr(), bucket_keys.data_ptr(),
                             bucket_vals.data_ptr(), found.data_ptr(),
                             values.data_ptr(), n_q, width, stream)
    if err:
        raise RuntimeError("clht_probe kernel launch failed: "
                           + lib.clht_probe_error_string(err).decode())
    LAUNCHES["clht_probe"] += 1
    return found, values


def tag_probe(queries: torch.Tensor, keys: torch.Tensor,
              vals: torch.Tensor, nxt: torch.Tensor, *, n_buckets: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries: [Q] int32; keys, vals: [R, SLOTS] int32 (row b < n_buckets
    is bucket b); nxt: [R] int32, the next row of a chain or -1, each a
    row of the table (the kernel does not check).  0 < n_buckets <= R <
    2^31.  Returns (found [Q] bool, values [Q] int32), bit-identical to
    ``tag_probe_plain``."""
    if queries.dim() != 1 or keys.dim() != 2 or keys.shape[1] != SLOTS \
            or keys.shape != vals.shape or nxt.shape != keys.shape[:1]:
        raise ValueError(f"queries must be [Q], keys and vals [R, {SLOTS}] "
                         f"and nxt [R], got {tuple(queries.shape)}, "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)} and "
                         f"{tuple(nxt.shape)}")
    for name, t in (("queries", queries), ("keys", keys), ("vals", vals),
                    ("nxt", nxt)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
    if not 0 < n_buckets <= keys.shape[0]:
        raise ValueError(f"n_buckets must lie in [1, {keys.shape[0]}] "
                         f"(the table's rows), got {n_buckets}")
    dev = queries.device
    if dev.type == "cpu":
        return tag_probe_plain(queries, keys, vals, nxt, n_buckets=n_buckets)
    if dev.type != "cuda":
        raise ValueError(f"tag_probe takes CUDA or CPU tensors, not {dev}")
    for name, t in (("queries", queries), ("keys", keys), ("vals", vals),
                    ("nxt", nxt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_q = queries.shape[0]
    found = torch.empty(n_q, dtype=torch.bool, device=dev)
    values = torch.empty(n_q, dtype=torch.int32, device=dev)
    if n_q == 0:
        return found, values
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tag_probe(queries.data_ptr(), keys.data_ptr(),
                            vals.data_ptr(), nxt.data_ptr(), n_q,
                            int(n_buckets), found.data_ptr(),
                            values.data_ptr(), stream)
    if err:
        raise RuntimeError("tag_probe kernel launch failed: "
                           + lib.clht_probe_error_string(err).decode())
    LAUNCHES["tag_probe"] += 1
    return found, values


__all__ = ["LAUNCHES", "clht_probe", "reset_launches", "tag_probe"]
