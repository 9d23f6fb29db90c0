"""The shard-routing kernel's wrapper (``csrc/shard_route.cu``).

``shard_route`` is the port's form of the JAX package's
``kernels/partition/kernel.py`` ``shard_route``.  On CUDA tensors it
launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.shard_route_plain``.  Nothing else selects
between the two.

``LAUNCHES`` counts kernel launches under the TPU kernel's name; a
call on CPU tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ... import build
from .ref import shard_route_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"shard_route": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("shard_route")
    lib.shard_route.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, _P, _P]
    lib.shard_route.restype = ctypes.c_int
    lib.shard_route_error_string.argtypes = [ctypes.c_int]
    lib.shard_route_error_string.restype = ctypes.c_char_p
    return lib


def shard_route(keys: torch.Tensor, *, bits: int, shift: int
                ) -> torch.Tensor:
    """keys: [Q] int64 PM keys.  Returns [Q] int32 shard ids in
    [0, 2^bits): the top ``bits`` of splitmix64 when ``shift`` < 0
    (``hash``), else key bits [shift, shift + bits) (``prefix``,
    ``prefix@<m>``); see ``ref.route_params``.  Bit-identical to
    ``shard_route_plain``."""
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"keys must be [Q] int64, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if not 0 <= bits <= 31 or shift > 63 or (shift >= 0
                                             and shift + bits > 63):
        raise ValueError(f"bad route: bits {bits}, shift {shift}")
    dev = keys.device
    if dev.type == "cpu":
        return shard_route_plain(keys, bits=bits, shift=shift)
    if dev.type != "cuda":
        raise ValueError(f"shard_route takes CUDA or CPU tensors, not {dev}")
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shard_route(keys.data_ptr(), n, int(bits), int(shift),
                              out.data_ptr(), stream)
    if err:
        raise RuntimeError("shard_route kernel launch failed: "
                           + lib.shard_route_error_string(err).decode())
    LAUNCHES["shard_route"] += 1
    return out


__all__ = ["LAUNCHES", "reset_launches", "shard_route"]
