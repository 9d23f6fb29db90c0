"""The sorted-run search kernel's wrappers (``csrc/scan_window.cu``).

``scan_window`` is the port's form of the JAX package's
``kernels/scan/kernel.py`` ``scan_window``; ``scan_window_rows`` is the
same kernel with a shard axis (each query row searches its own run of
a stacked array), which the sharded mesh read path
(``distributed/mesh.py``) launches once for all shards.  On CUDA
tensors each launches the CUDA kernel on the current stream, or
raises; on CPU tensors it runs its plain version
(``ref.scan_window_plain``, ``ref.scan_window_rows_plain``).  Nothing
else selects between the two.

``LAUNCHES`` counts kernel launches, ``scan_window`` under the TPU
kernel's name and the shard-axis form as ``scan_window_sharded``;
``WINDOWS`` splits the same launches by window width C (``max_count``),
``{name: {C: launches}}``.  A call on CPU tensors launches nothing and
counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import scan_window_plain, scan_window_rows_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"scan_window": 0, "scan_window_sharded": 0}
#: the same launches by window width
WINDOWS: Dict[str, Dict[int, int]] = {name: {} for name in LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        WINDOWS[name].clear()


def _count(name: str, max_count: int) -> None:
    LAUNCHES[name] += 1
    WINDOWS[name][max_count] = WINDOWS[name].get(max_count, 0) + 1


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("scan_window")
    lib.scan_window.argtypes = [_P] * 4 + [ctypes.c_longlong,
                                           ctypes.c_longlong,
                                           ctypes.c_int] + [_P] * 4
    lib.scan_window.restype = ctypes.c_int
    lib.scan_window_rows.argtypes = [_P] * 6 + [ctypes.c_longlong,
                                                ctypes.c_longlong,
                                                ctypes.c_int] + [_P] * 4
    lib.scan_window_rows.restype = ctypes.c_int
    lib.scan_window_error_string.argtypes = [ctypes.c_int]
    lib.scan_window_error_string.restype = ctypes.c_char_p
    return lib


def _check(queries, counts, keys, vals, max_count, rows=()) -> None:
    if queries.dim() != 1 or keys.dim() != 1:
        raise ValueError("queries must be [Q] and keys [N]")
    if max_count < 1:
        raise ValueError(f"max_count must be at least 1, got {max_count}")
    n_q, n = queries.shape[0], keys.shape[0]
    dev = queries.device
    for name, t, dtype, shape in (
            ("queries", queries, torch.int64, (n_q,)),
            ("counts", counts, torch.int32, (n_q,)),
            ("keys", keys, torch.int64, (n,)),
            ("vals", vals, torch.int64, (n,))) + tuple(
                (name, t, torch.int64, (n_q,)) for name, t in rows):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def scan_window(queries: torch.Tensor, counts: torch.Tensor,
                keys: torch.Tensor, vals: torch.Tensor, *, max_count: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lower bound + window gather over a sorted run.

    queries: [Q] int64 start keys; counts: [Q] int32 window widths;
    keys, vals: [N] int64 run, keys ascending in signed order.  Returns
    (valid [Q, C] bool, keys, vals [Q, C] int64), C = ``max_count``,
    each row a prefix mask; bit-identical to ``scan_window_plain``."""
    _check(queries, counts, keys, vals, max_count)
    dev = queries.device
    if dev.type == "cpu":
        return scan_window_plain(queries, counts, keys, vals,
                                 max_count=max_count)
    if dev.type != "cuda":
        raise ValueError(f"scan_window takes CUDA or CPU tensors, not {dev}")
    n_q = queries.shape[0]
    valid = torch.empty((n_q, max_count), dtype=torch.bool, device=dev)
    okeys = torch.empty((n_q, max_count), dtype=torch.int64, device=dev)
    ovals = torch.empty((n_q, max_count), dtype=torch.int64, device=dev)
    if n_q == 0:
        return valid, okeys, ovals
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_window(
            queries.data_ptr(), counts.data_ptr(), keys.data_ptr(),
            vals.data_ptr(), n_q, keys.shape[0], int(max_count),
            valid.data_ptr(), okeys.data_ptr(), ovals.data_ptr(), stream)
    if err:
        raise RuntimeError("scan_window kernel launch failed: "
                           + lib.scan_window_error_string(err).decode())
    _count("scan_window", max_count)
    return valid, okeys, ovals


def scan_window_rows(queries: torch.Tensor, counts: torch.Tensor,
                     base: torch.Tensor, length: torch.Tensor,
                     keys: torch.Tensor, vals: torch.Tensor, *,
                     max_count: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``scan_window`` with a shard axis: row ``i`` searches the run
    ``keys[base[i]:base[i] + length[i]]`` (ascending in signed order)
    and its window stops at that run's end.

    base, length: [Q] int64; every row's run must lie within the N
    entries of keys and vals (the caller builds them from the stacked
    runs' offsets; the kernel does not check, since that would need the
    values on the host).  Returns (valid [Q, C] bool, keys, vals
    [Q, C] int64); bit-identical to ``scan_window_rows_plain``."""
    _check(queries, counts, keys, vals, max_count,
           rows=(("base", base), ("length", length)))
    dev = queries.device
    if dev.type == "cpu":
        return scan_window_rows_plain(queries, counts, base, length, keys,
                                      vals, max_count=max_count)
    if dev.type != "cuda":
        raise ValueError(f"scan_window_rows takes CUDA or CPU tensors, "
                         f"not {dev}")
    n_q = queries.shape[0]
    valid = torch.empty((n_q, max_count), dtype=torch.bool, device=dev)
    okeys = torch.empty((n_q, max_count), dtype=torch.int64, device=dev)
    ovals = torch.empty((n_q, max_count), dtype=torch.int64, device=dev)
    if n_q == 0:
        return valid, okeys, ovals
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_window_rows(
            queries.data_ptr(), counts.data_ptr(), base.data_ptr(),
            length.data_ptr(), keys.data_ptr(), vals.data_ptr(), n_q,
            keys.shape[0], int(max_count), valid.data_ptr(),
            okeys.data_ptr(), ovals.data_ptr(), stream)
    if err:
        raise RuntimeError("scan_window_rows kernel launch failed: "
                           + lib.scan_window_error_string(err).decode())
    _count("scan_window_sharded", max_count)
    return valid, okeys, ovals


__all__ = ["LAUNCHES", "WINDOWS", "reset_launches", "scan_window",
           "scan_window_rows"]
