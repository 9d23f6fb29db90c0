"""The paged decode-attention kernel's wrapper (``csrc/paged_attention.cu``).

``paged_attention`` is the port's form of the JAX package's
``kernels/paged_attention/kernel.py`` ``paged_attention``.  The pages
may hold fewer kv heads than q has heads (the Pallas kernel needs them
repeated by its caller): query head h reads kv head h // (H // Hk).  On
CUDA tensors it launches the CUDA kernel on the current stream, or
raises; on CPU tensors it runs ``ref.paged_attention_plain``.  Nothing
else selects between the two.

The kernel cuts each sequence's keys into splits of whole pages that
run in parallel, one thread-block cluster a (sequence, kv head), and
merges them on chip (``ref.merge_partials`` is the merge's plain form).
``split_plan`` chooses the splits from the block table's shape and the
SM count alone, never from ``seq_lens``, so the wrapper reads nothing
from the device and allocates nothing but the output.  With a sliding
``window`` each block finds its sequence's first live key on the card
and starts at the page that holds it: pages wholly before the window are
never read, and a split that lies wholly before it stores an empty
partial.

With ``return_lse`` the kernel also stores each (sequence, query
head)'s log-sum-exp of its live scores, M + log(L) in fp32 (-inf where
no key is live), from the block that merges the head's splits: the
merged output is bit for bit the one without it.  Slot shards of one
cache merge by it (``models/attention.py`` ``merge_by_lse``).  A
length past MAXP * PS reads the table's keys with the window starting
at the unclamped length less the window (a slot shard's length, ``pos +
1 - off``, passes its table when ``pos`` lies on a later shard), and a
length of 0 or less reads nothing.

The pages hold q's dtype, or int8 (the ``kv_int8`` cache, q in bf16 or
fp32): the kernel converts each int8 key and value it loads to fp32 and
multiplies it by ``kv_scale`` in registers, so no dequantized copy of
the cache is made.

``LAUNCHES`` counts kernel launches under the TPU kernel's name, those
over int8 pages under ``"paged_attention int8"``; ``WINDOWED`` counts
those of the same launches that took a sliding window, by the same
names.  A call on CPU tensors
launches nothing and counts nothing.  On ``meta`` tensors (the dry run)
the wrapper launches nothing either: it charges the kernel's work
(``analysis.roofline.paged_work``, every page of the table, since a
``meta`` length has no value, and the log-sum-exp's store where it is
asked for) and returns an output of q's shape (and the log-sum-exp's).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ... import build
from ..grad_guard import refuse_grad
from .ref import paged_attention_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"paged_attention": 0, "paged_attention int8": 0}
#: the same launches that took a sliding window
WINDOWED: Dict[str, int] = {"paged_attention": 0, "paged_attention int8": 0}

HEAD_DIMS = (32, 64, 128)  # the head widths the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {**DTYPES, torch.int8: 2}  # the pages' types
MAX_SPLITS = 8  # splits of a sequence: one cluster, the portable size


def heads_per_block(group_size: int) -> int:
    """Query heads one block computes, of the ``group_size`` query heads
    that share a kv head: the fewest of 4, 8 and 32 that hold the group
    (a block's teams of 4 warps take 1, 2 or 8 heads a warp); a larger
    group takes further blocks.  The CUDA kernel is built for these
    three counts, takes the count from here and rejects any other."""
    return 4 if group_size <= 4 else 8 if group_size <= 8 else 32


def split_plan(max_pages: int, batch: int, heads: int, kv_heads: int,
               sms: int = 132) -> Tuple[int, int]:
    """(pages per split, splits) for a table of ``max_pages`` pages: the
    largest power of two of splits, at most ``MAX_SPLITS`` and no more
    than there are pages, that keeps batch x kv heads x head groups x
    splits blocks within half of ``sms`` SMs (beyond that, clusters of 8
    large blocks no longer all fit at once, and on an H100 8 splits ran
    slower than 4 at 16 blocks), then the fewest whole pages a split
    that cover the table.  Split s covers pages [s * pages, (s + 1) *
    pages); the last splits may lie past the table.  Nothing depends on
    the sequences' lengths."""
    group_size = heads // kv_heads
    groups = -(-group_size // heads_per_block(group_size))
    blocks = batch * kv_heads * groups
    n_splits = 1
    while (n_splits < MAX_SPLITS and 2 * n_splits <= max_pages
           and 4 * n_splits * blocks <= sms):
        n_splits *= 2
    return max(1, -(-max_pages // n_splits)), n_splits


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        WINDOWED[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    lib.paged_attention.argtypes = ([_P] * 7 + [_I] * 12
                                    + [ctypes.c_float] * 2 + [_P])
    lib.paged_attention.restype = _I
    lib.paged_attention_error_string.argtypes = [_I]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, pages_k, pages_v, block_table, seq_lens, window,
           kv_scale) -> None:
    if q.dim() != 3 or pages_k.dim() != 4:
        raise ValueError("q must be [B, H, dh] and the pages [NP, PS, Hk, dh]")
    B, H, dh = q.shape
    if pages_v.shape != pages_k.shape or pages_k.shape[3] != dh:
        raise ValueError(f"pages_k and pages_v must be [NP, PS, Hk, dh={dh}] "
                         f"alike, got {tuple(pages_k.shape)} and "
                         f"{tuple(pages_v.shape)}")
    Hk = pages_k.shape[2]
    if Hk < 1 or H % Hk:
        raise ValueError(f"{H} query heads are not a multiple of {Hk} kv "
                         "heads")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, MAXP]")
    if tuple(seq_lens.shape) != (B,):
        raise ValueError(f"seq_lens must be [B={B}]")
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if pages_v.dtype != pages_k.dtype:
        raise TypeError(f"pages_v is {pages_v.dtype}, pages_k is "
                        f"{pages_k.dtype}")
    if pages_k.dtype == torch.int8:
        if kv_scale is None:
            raise ValueError("int8 pages need the kv_scale that dequantizes "
                             "them")
    elif pages_k.dtype != q.dtype:
        raise TypeError(f"the pages are {pages_k.dtype}, q is {q.dtype}: "
                        "they take q's dtype, or int8")
    elif kv_scale is not None:
        raise ValueError(f"kv_scale dequantizes int8 pages; these are "
                         f"{pages_k.dtype}")
    for name, t in (("block_table", block_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive width, got {window}")


def paged_attention(q: torch.Tensor, pages_k: torch.Tensor,
                    pages_v: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor,
                    window: Optional[int] = None, *,
                    kv_scale: Optional[float] = None,
                    return_lse: bool = False):
    """One-token decode attention over block-table pages.

    q: [B, H, dh], float32 or bfloat16; pages_k, pages_v: [NP, PS, Hk,
    dh], H % Hk == 0, in q's dtype, or int8 with ``kv_scale`` (each
    element read as its value times ``kv_scale``); block_table: [B,
    MAXP] int32, entries below 0 read page 0; seq_lens: [B] int32.  Keys
    j < seq_lens[b] (at most MAXP * PS) are live, and with a ``window``
    (at least 1) only those with j >= seq_lens[b] - window.  fp32
    accumulation; returns [B, H, dh] in q's dtype, zeros for a sequence
    with no live key, and with ``return_lse`` also the log-sum-exp [B,
    H] fp32 of the live scores q.k / sqrt(dh), -inf for such a
    sequence."""
    _check(q, pages_k, pages_v, block_table, seq_lens, window, kv_scale)
    refuse_grad("paged_attention", q, pages_k, pages_v)
    dev = q.device
    int8 = pages_k.dtype == torch.int8
    if dev.type == "cpu":
        return paged_attention_plain(q, pages_k, pages_v, block_table,
                                     seq_lens, window, kv_scale=kv_scale,
                                     return_lse=return_lse)
    B, H, dh = q.shape
    _, PS, Hk, _ = pages_k.shape
    if dev.type == "meta":
        from ...analysis.roofline import charge, paged_work
        slots = block_table.shape[1] * PS
        live = min(slots, window) if window is not None else slots
        charge("paged_attention int8" if int8 else "paged_attention",
               paged_work([live] * B, H, Hk, dh, PS, q.element_size(),
                          pages_k.element_size(), lse=return_lse))
        out = torch.empty_like(q)
        return (out, _lse_of(q)) if return_lse else out
    if dev.type != "cuda":
        raise ValueError(f"paged_attention takes CUDA or CPU tensors, "
                         f"not {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernel "
                             "reads key rows 16 bytes (8 bf16, 4 fp32 or "
                             "16 int8 elements) at a time")
    out = torch.empty_like(q)
    lse = _lse_of(q) if return_lse else None
    if B == 0:
        return (out, lse) if return_lse else out
    lib = _library()
    maxp = block_table.shape[1]
    pages, n_splits = split_plan(maxp, B, H, Hk, _sm_count(dev.index))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, H, Hk, dh, PS, maxp,
            pages, n_splits, heads_per_block(H // Hk), int(window or 0),
            DTYPES[q.dtype], KV_DTYPES[pages_k.dtype], 1.0 / math.sqrt(dh),
            float(kv_scale or 1.0), stream)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paged_attention_error_string(err).decode())
    name = "paged_attention int8" if int8 else "paged_attention"
    LAUNCHES[name] += 1
    if window is not None:
        WINDOWED[name] += 1
    return (out, lse) if return_lse else out


def _lse_of(q: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp's output for q [B, H, dh]: [B, H] fp32."""
    return torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)


__all__ = ["DTYPES", "HEAD_DIMS", "KV_DTYPES", "LAUNCHES", "MAX_SPLITS",
           "WINDOWED", "heads_per_block", "paged_attention",
           "reset_launches", "split_plan"]
