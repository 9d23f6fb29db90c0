"""The wrappers of ``csrc/shard_route.cu``: routing and the partition.

``shard_route`` is the port's form of the JAX package's
``kernels/partition/kernel.py`` ``shard_route``.  ``shard_partition``
routes a batch and sorts it stably by shard in one call on the card (the
JAX package's ``partition_ref``, which it computes on the host).  On
CUDA tensors each launches its kernel on the current stream, or raises;
on CPU tensors each runs its plain version in ``ref``.  Nothing else
selects between the two.

``LAUNCHES`` counts one a call that launches (``shard_partition``'s
tiled form runs three kernels a call); a call on CPU tensors launches
nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import shard_partition_plain, shard_route_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"shard_route": 0, "shard_partition": 0}
#: the most shards ``shard_partition`` takes, as a power of two (the
#: source's kMaxShardBits; the port's limit P2)
MAX_PARTITION_BITS = 12


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
    lib.shard_partition.argtypes = [_P, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int] + [_P] * 5
    lib.shard_partition.restype = ctypes.c_int
    lib.shard_partition_scratch_bytes.argtypes = [ctypes.c_longlong,
                                                  ctypes.c_int]
    lib.shard_partition_scratch_bytes.restype = ctypes.c_longlong
    lib.shard_route_error_string.argtypes = [ctypes.c_int]
    lib.shard_route_error_string.restype = ctypes.c_char_p
    return lib


def _check_route(name: str, keys: torch.Tensor, bits: int,
                 shift: int) -> None:
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError(f"keys must be [Q] int64, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if not 0 <= bits <= 31 or shift > 63 or (shift >= 0
                                             and shift + bits > 63):
        raise ValueError(f"bad route: bits {bits}, shift {shift}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CUDA or CPU tensors, not "
                         f"{keys.device}")


def shard_route(keys: torch.Tensor, *, bits: int, shift: int
                ) -> torch.Tensor:
    """keys: [Q] int64 PM keys.  Returns [Q] int32 shard ids in
    [0, 2^bits): the top ``bits`` of splitmix64 when ``shift`` < 0
    (``hash``), else key bits [shift, shift + bits) (``prefix``,
    ``prefix@<m>``); see ``ref.route_params``.  Bit-identical to
    ``shard_route_plain``."""
    _check_route("shard_route", keys, bits, shift)
    dev = keys.device
    if dev.type == "cpu":
        return shard_route_plain(keys, bits=bits, shift=shift)
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


def shard_partition(keys: torch.Tensor, *, bits: int, shift: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """keys: [Q] int64 PM keys, routed as ``shard_route`` routes them.
    Returns (shards [Q] int32, order [Q] int32, offsets [2^bits + 1]
    int32): ``order`` is the stable sort-by-shard permutation and
    ``order[offsets[s]:offsets[s + 1]]`` shard s's positions, ascending.
    At most ``2^MAX_PARTITION_BITS`` shards and 2^31 - 1 keys.
    Bit-identical to ``shard_partition_plain``."""
    _check_route("shard_partition", keys, bits, shift)
    if bits > MAX_PARTITION_BITS:
        raise ValueError(f"shard_partition takes at most "
                         f"2^{MAX_PARTITION_BITS} shards (port limit P2), "
                         f"got 2^{bits}")
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"shard_partition takes fewer than 2^31 keys, "
                         f"got {n}")
    dev = keys.device
    if dev.type == "cpu":
        return shard_partition_plain(keys, bits=bits, shift=shift)
    shards = torch.empty(n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty((1 << bits) + 1, dtype=torch.int32, device=dev)
    lib = _library()
    n_scratch = lib.shard_partition_scratch_bytes(n, int(bits))
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=dev)
               if n_scratch else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shard_partition(
            keys.data_ptr(), n, int(bits), int(shift), shards.data_ptr(),
            order.data_ptr(), offsets.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    if err:
        raise RuntimeError("shard_partition kernel launch failed: "
                           + lib.shard_route_error_string(err).decode())
    LAUNCHES["shard_partition"] += 1
    return shards, order, offsets


__all__ = ["LAUNCHES", "MAX_PARTITION_BITS", "reset_launches",
           "shard_partition", "shard_route"]
