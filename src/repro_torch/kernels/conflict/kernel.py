"""The conflict-admission kernel's wrapper (``csrc/conflict_any.cu``).

``conflict_any`` is the port's form of the JAX package's
``kernels/conflict/kernel.py`` ``conflict_any_kernel``.  On CUDA
tensors it launches the CUDA kernel on the current stream, or raises;
on CPU tensors it runs ``ref.conflict_any_plain``.  Nothing else
selects between the two.

``LAUNCHES`` counts kernel launches under the name ``conflict_any``; a
call on CPU tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ... import build
from .ref import conflict_any_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"conflict_any": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("conflict_any")
    lib.conflict_any.argtypes = [_P, _P, ctypes.c_longlong, _P, _P,
                                 ctypes.c_longlong, ctypes.c_int, _P, _P]
    lib.conflict_any.restype = ctypes.c_int
    lib.conflict_any_error_string.argtypes = [ctypes.c_int]
    lib.conflict_any_error_string.restype = ctypes.c_char_p
    return lib


def _check(kinds_a, keys_a, kinds_b, keys_b) -> None:
    dev = kinds_a.device
    for name, t, dtype, other in (("kinds_a", kinds_a, torch.int32, keys_a),
                                  ("keys_a", keys_a, torch.int64, kinds_a),
                                  ("kinds_b", kinds_b, torch.int32, keys_b),
                                  ("keys_b", keys_b, torch.int64, kinds_b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, kinds_a on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape != other.shape:
            raise ValueError(f"{name} must be 1-D and match its set, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def conflict_any(kinds_a: torch.Tensor, keys_a: torch.Tensor,
                 kinds_b: torch.Tensor, keys_b: torch.Tensor, *,
                 writes_conflict: bool = False) -> torch.Tensor:
    """kinds_a [A] int32, keys_a [A] int64: the candidate ops; kinds_b,
    keys_b [B]: the reference set.  Returns [A] bool, True where the
    candidate conflicts with some reference op (``ref.py``'s rules,
    the order test signed int64).  Bit-identical to
    ``conflict_any_plain``."""
    _check(kinds_a, keys_a, kinds_b, keys_b)
    dev = kinds_a.device
    if dev.type == "cpu":
        return conflict_any_plain(kinds_a, keys_a, kinds_b, keys_b,
                                  writes_conflict=writes_conflict)
    if dev.type != "cuda":
        raise ValueError(f"conflict_any takes CUDA or CPU tensors, not {dev}")
    n_a, n_b = kinds_a.shape[0], kinds_b.shape[0]
    out = torch.zeros(n_a, dtype=torch.bool, device=dev)
    if n_a == 0 or n_b == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conflict_any(kinds_a.data_ptr(), keys_a.data_ptr(), n_a,
                               kinds_b.data_ptr(), keys_b.data_ptr(), n_b,
                               int(writes_conflict), out.data_ptr(), stream)
    if err:
        raise RuntimeError("conflict_any kernel launch failed: "
                           + lib.conflict_any_error_string(err).decode())
    LAUNCHES["conflict_any"] += 1
    return out


__all__ = ["LAUNCHES", "conflict_any", "reset_launches"]
