"""The radix-descent kernel's wrapper (``csrc/art_descend.cu``).

``art_descend`` is the port's form of the JAX package's
``kernels/art_probe/kernel.py`` ``art_descend``.  On CUDA tensors it
launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.descend_plain``.  Nothing else selects between
the two.

``pack_entries`` packs the child table once an epoch, in place, with
a second kernel of the same source.

``LAUNCHES`` counts kernel launches, the descent's under the TPU
kernel's name; a call on CPU tensors launches nothing and counts
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import LEAF_BIT, LEVEL_MASK, descend_plain, pack_entries_plain

#: CUDA launches since the last ``reset_launches``: the descent, and the
#: per-epoch packing of its child entries
LAUNCHES: Dict[str, int] = {"art_descend": 0, "art_pack_entries": 0}

UNIT_BITS = (8, 4)  # P-ART bytes, P-HOT nibbles


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("art_descend")
    lib.art_descend.argtypes = [_P] * 2 + [ctypes.c_int] + [_P] * 3 + [
        ctypes.c_longlong] * 2 + [ctypes.c_int] + [_P] * 6
    lib.art_descend.restype = ctypes.c_int
    lib.art_pack_entries.argtypes = [_P, _P, ctypes.c_longlong,
                                     ctypes.c_longlong, _P]
    lib.art_pack_entries.restype = ctypes.c_int
    lib.art_descend_error_string.argtypes = [ctypes.c_int]
    lib.art_descend_error_string.restype = ctypes.c_char_p
    return lib


def _check(queries, children, root, lfp, leaf_key, leaf_val,
           unit_bits) -> None:
    if unit_bits not in UNIT_BITS:
        raise ValueError(f"unit_bits must be 8 or 4, got {unit_bits}")
    if queries.dim() != 1 or children.dim() != 2:
        raise ValueError("queries must be [Q] and children [N, fan]")
    n_q, n_nodes = queries.shape[0], children.shape[0]
    if n_nodes < 1:
        raise ValueError("the node pages must hold at least the root")
    if not 0 <= root <= LEAF_BIT | LEVEL_MASK or \
            (root & LEVEL_MASK) >= 64 // unit_bits:
        raise ValueError(f"root header {root} is not a clamped level and "
                         "a leaf bit")
    dev = queries.device
    for name, t, dtype, shape in (
            ("queries", queries, torch.int64, (n_q,)),
            ("children", children, torch.int32, (n_nodes, 1 << unit_bits)),
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


def art_descend(queries: torch.Tensor, children: torch.Tensor, root: int,
                lfp: torch.Tensor, leaf_key: torch.Tensor,
                leaf_val: torch.Tensor, *, unit_bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Descend the node pages once per query.

    queries: [Q] int64; children: [N, 2^unit_bits] int32 packed child
    entries (``ops.pack_children``: row | clamped level << 26 | leaf
    << 30, -1 none), node 0 the root; root: the root's header (clamped
    level | leaf << 4); lfp: [N] uint8, the export's partial-key
    fingerprint lane (0 on inner rows); leaf_key, leaf_val: [N] int64.
    Returns (found [Q] bool, values [Q] int64, nenc, nfp, nfalse [Q]
    int32: leaves reached, fingerprint matches, and matches the full key
    or a tombstone rejected), bit-identical to ``descend_plain``."""
    _check(queries, children, root, lfp, leaf_key, leaf_val, unit_bits)
    dev = queries.device
    if dev.type == "cpu":
        return descend_plain(queries, children, root, lfp, leaf_key,
                             leaf_val, unit_bits=unit_bits)
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
            queries.data_ptr(), children.data_ptr(), int(root),
            lfp.data_ptr(), leaf_key.data_ptr(), leaf_val.data_ptr(), n_q,
            children.shape[0], int(unit_bits), found.data_ptr(),
            values.data_ptr(), nenc.data_ptr(), nfp.data_ptr(),
            nfalse.data_ptr(), stream)
    if err:
        raise RuntimeError("art_descend kernel launch failed: "
                           + lib.art_descend_error_string(err).decode())
    LAUNCHES["art_descend"] += 1
    return found, values, nenc, nfp, nfalse


def pack_entries(children: torch.Tensor, hdr: torch.Tensor) -> None:
    """Pack each child's header into its parent's entries, in place.

    children: [N, fan] int32 child rows (-1 none); hdr: [N] int32, each
    row's clamped level | leaf << 4.  On CUDA tensors one pass of the
    CUDA source's packing kernel, or raises; on CPU tensors
    ``ref.pack_entries_plain``; bit-identical."""
    if children.dim() != 2 or children.dtype != torch.int32 or \
            not children.is_contiguous():
        raise ValueError("children must be a contiguous [N, fan] int32 "
                         "tensor")
    n_nodes = children.shape[0]
    if hdr.shape != (n_nodes,) or hdr.dtype != torch.int32 or \
            hdr.device != children.device or not hdr.is_contiguous():
        raise ValueError(f"hdr must be a contiguous [{n_nodes}] int32 "
                         f"tensor on {children.device}")
    dev = children.device
    if dev.type == "cpu":
        pack_entries_plain(children, hdr)
        return
    if dev.type != "cuda":
        raise ValueError(f"pack_entries takes CUDA or CPU tensors, not {dev}")
    if children.numel() == 0:
        return
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.art_pack_entries(
            children.data_ptr(), hdr.data_ptr(), children.numel(), n_nodes,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("art_pack_entries kernel launch failed: "
                           + lib.art_descend_error_string(err).decode())
    LAUNCHES["art_pack_entries"] += 1


__all__ = ["LAUNCHES", "UNIT_BITS", "art_descend",
           "pack_entries", "reset_launches"]
