"""The chained probe's line table, built once an epoch.

One 64-byte line per row, in the image of CLHT's own cache-line bucket:

    w0-w2  the row's three keys
    w3-w5  its three values
    w6     the line where the rest of its chain starts, -1 at the end
    w7     bits 0-23 the three fingerprint bytes (slot s in bits 8s to
           8s+7), bits 32-63 the number of rows after it in its chain

Rows keep their index: line r is row r.  After the R rows comes a
region of chain copies: each chain's rows after its head, copied in hop
order, so a row at chain position p points p lines into its chain's
copy.  Any row can start a probe, and its chain's remaining rows lie on
consecutive lines whose addresses the start line alone gives, so a
probe makes one dependent load for its start line and then loads the
rest of its chain together (``csrc/probe.cu``).  A copy carries its
row's w6 and w7, so a copy read as a start line reads as its row.  The
region costs one line per row that has a predecessor.

The rows must form disjoint chains: a row with two predecessors, or a
cycle, raises.  CLHT exports have neither.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LINE_WORDS = 8
#: the longest chain a probe walks (a longer chain is cut to its first
#: MAX_DEPTH rows, as the JAX package's snapshot lookup cuts it)
MAX_DEPTH = 64
COUNT_SHIFT = 32


def _put(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def chain_walk(nxt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chain [R], pos [R], length [C]) int64 on ``nxt``'s device: each
    row's chain, its position in it (0 at the chain's first row) and
    each chain's row count.  A chain starts at every row no other row
    points to; raises on a pointer out of range, a row with two
    predecessors, or a cycle.  One step a hop, over the rows still
    walking, so the whole walk touches each row once."""
    n_rows = nxt.shape[0]
    if bool(((nxt < -1) | (nxt >= n_rows)).any()):
        raise ValueError("chain pointers out of range")
    preds = torch.bincount(nxt[nxt >= 0], minlength=n_rows)
    if bool((preds > 1).any()):
        raise ValueError(f"row {int(torch.argmax((preds > 1).byte()))} has "
                         "two predecessors: chains must be disjoint")
    cur = torch.nonzero(preds == 0).squeeze(1)
    n_chains = cur.shape[0]
    chain = torch.full((n_rows,), -1, dtype=torch.int64, device=nxt.device)
    pos = torch.zeros(n_rows, dtype=torch.int64, device=nxt.device)
    ids = torch.arange(n_chains, device=nxt.device)
    p = 0
    while cur.numel():
        chain[cur] = ids
        pos[cur] = p
        nx = nxt[cur]
        keep = nx >= 0
        cur, ids, p = nx[keep], ids[keep], p + 1
    if bool((chain < 0).any()):
        raise ValueError(f"row {int(torch.argmax((chain < 0).byte()))} lies "
                         "on a cycle of chain pointers")
    return chain, pos, torch.bincount(chain, minlength=n_chains)


def pack_lines(keys: np.ndarray, vals: np.ndarray, fps: np.ndarray,
               nxt: np.ndarray, *, device: torch.device
               ) -> Tuple[torch.Tensor, int]:
    """The line table of a snapshot's rows (keys, vals [R, 3] int64, fps
    [R, 3] uint8, nxt [R] int64 with -1 at a chain's end) on ``device``,
    and the depth a probe walks: the longest chain, at most MAX_DEPTH.
    Returns ([R + E, 8] int64, depth), E the rows that have a
    predecessor.  The four arrays are uploaded as they are and the table
    is laid out on ``device``."""
    nxt = _put(nxt, np.int64, device)
    chain, pos, length = chain_walk(nxt)
    n_rows = nxt.shape[0]
    tail = length - 1
    base = n_rows + torch.cumsum(tail, 0) - tail
    rest = tail[chain] - pos
    first = base[chain] + pos  # the line that holds the next row's copy
    f = _put(fps, np.uint8, device).to(torch.int64)
    copied = torch.nonzero(pos > 0).squeeze(1)
    src = torch.empty_like(copied)
    src[first[copied] - 1 - n_rows] = copied
    lines = torch.empty((n_rows + src.shape[0], LINE_WORDS),
                        dtype=torch.int64, device=device)
    lines[:n_rows, 0:3] = _put(keys, np.int64, device)
    lines[:n_rows, 3:6] = _put(vals, np.int64, device)
    lines[:n_rows, 6] = torch.where(rest > 0, first, -1)
    lines[:n_rows, 7] = (f[:, 0] | (f[:, 1] << 8) | (f[:, 2] << 16)
                         | (rest << COUNT_SHIFT))
    torch.index_select(lines[:n_rows], 0, src, out=lines[n_rows:])
    depth = int(length.max()) if length.numel() else 1
    return lines, min(depth, MAX_DEPTH)


__all__ = ["COUNT_SHIFT", "LINE_WORDS", "MAX_DEPTH", "chain_walk",
           "pack_lines"]
