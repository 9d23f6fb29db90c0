"""The radix-descent kernel's wrapper (``csrc/art_descend.cu``).

``art_descend`` is the port's form of the JAX package's
``kernels/art_probe/kernel.py`` ``art_descend``.  On CUDA tensors it
launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.descend_plain``.  Nothing else selects between
the two.

``LAUNCHES`` counts kernel launches under the TPU kernel's name; a
call on CPU tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import descend_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"art_descend": 0}

UNIT_BITS = (8, 4)  # P-ART bytes, P-HOT nibbles


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("art_descend")
    lib.art_descend.argtypes = [_P] * 7 + [ctypes.c_longlong,
                                           ctypes.c_longlong,
                                           ctypes.c_int] + [_P] * 6
    lib.art_descend.restype = ctypes.c_int
    lib.art_descend_error_string.argtypes = [ctypes.c_int]
    lib.art_descend_error_string.restype = ctypes.c_char_p
    return lib


def _check(queries, children, level, is_leaf, lfp, leaf_key, leaf_val,
           unit_bits) -> None:
    if unit_bits not in UNIT_BITS:
        raise ValueError(f"unit_bits must be 8 or 4, got {unit_bits}")
    if queries.dim() != 1 or children.dim() != 2:
        raise ValueError("queries must be [Q] and children [N, fan]")
    n_q, n_nodes = queries.shape[0], children.shape[0]
    if n_nodes < 1:
        raise ValueError("the node pages must hold at least the root")
    dev = queries.device
    for name, t, dtype, shape in (
            ("queries", queries, torch.int64, (n_q,)),
            ("children", children, torch.int32, (n_nodes, 1 << unit_bits)),
            ("level", level, torch.int32, (n_nodes,)),
            ("is_leaf", is_leaf, torch.uint8, (n_nodes,)),
            ("lfp", lfp, torch.uint8, (n_nodes,)),
            ("leaf_key", leaf_key, torch.int64, (n_nodes,)),
            ("leaf_val", leaf_val, torch.int64, (n_nodes,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def art_descend(queries: torch.Tensor, children: torch.Tensor,
                level: torch.Tensor, is_leaf: torch.Tensor,
                lfp: torch.Tensor, leaf_key: torch.Tensor,
                leaf_val: torch.Tensor, *, unit_bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Descend the node pages once per query.

    queries: [Q] int64; children: [N, 2^unit_bits] int32 child rows
    (-1 none), node 0 the root; level: [N] int32 unit position of each
    inner node; is_leaf, lfp: [N] uint8 (lfp is the export's partial-key
    fingerprint lane, 0 on inner rows); leaf_key, leaf_val: [N] int64.
    Returns (found [Q] bool, values [Q] int64, nenc, nfp, nfalse [Q]
    int32: leaves reached, fingerprint matches, and matches the full key
    or a tombstone rejected), bit-identical to ``descend_plain``."""
    _check(queries, children, level, is_leaf, lfp, leaf_key, leaf_val,
           unit_bits)
    dev = queries.device
    if dev.type == "cpu":
        return descend_plain(queries, children, level, is_leaf, lfp,
                             leaf_key, leaf_val, unit_bits=unit_bits)
    if dev.type != "cuda":
        raise ValueError(f"art_descend takes CUDA or CPU tensors, not {dev}")
    n_q = queries.shape[0]
    found = torch.empty(n_q, dtype=torch.bool, device=dev)
    values = torch.empty(n_q, dtype=torch.int64, device=dev)
    nenc, nfp, nfalse = (torch.empty(n_q, dtype=torch.int32, device=dev)
                         for _ in range(3))
    if n_q == 0:
        return found, values, nenc, nfp, nfalse
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.art_descend(
            queries.data_ptr(), children.data_ptr(), level.data_ptr(),
            is_leaf.data_ptr(), lfp.data_ptr(), leaf_key.data_ptr(),
            leaf_val.data_ptr(), n_q, children.shape[0], int(unit_bits),
            found.data_ptr(), values.data_ptr(), nenc.data_ptr(),
            nfp.data_ptr(), nfalse.data_ptr(), stream)
    if err:
        raise RuntimeError("art_descend kernel launch failed: "
                           + lib.art_descend_error_string(err).decode())
    LAUNCHES["art_descend"] += 1
    return found, values, nenc, nfp, nfalse


__all__ = ["LAUNCHES", "UNIT_BITS", "art_descend", "reset_launches"]
