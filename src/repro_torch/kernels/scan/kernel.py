"""The sorted-run search kernel's wrapper (``csrc/scan_window.cu``).

``scan_window`` is the port's form of the JAX package's
``kernels/scan/kernel.py`` ``scan_window``.  On CUDA tensors it
launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.scan_window_plain``.  Nothing else selects
between the two.

``LAUNCHES`` counts kernel launches under the TPU kernel's name; a
call on CPU tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import scan_window_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"scan_window": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("scan_window")
    lib.scan_window.argtypes = [_P] * 4 + [ctypes.c_longlong,
                                           ctypes.c_longlong,
                                           ctypes.c_int] + [_P] * 4
    lib.scan_window.restype = ctypes.c_int
    lib.scan_window_error_string.argtypes = [ctypes.c_int]
    lib.scan_window_error_string.restype = ctypes.c_char_p
    return lib


def _check(queries, counts, keys, vals, max_count) -> None:
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
            ("vals", vals, torch.int64, (n,))):
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
    LAUNCHES["scan_window"] += 1
    return valid, okeys, ovals


__all__ = ["LAUNCHES", "reset_launches", "scan_window"]
