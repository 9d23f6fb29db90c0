"""One copy a read wave: a kernel's outputs back on the host together.

``to_host`` gathers the bytes of several device tensors into one buffer
on their device (one ``torch.cat``, no other kernel), copies that buffer
to the host once, and splits it back into numpy arrays of the tensors'
dtypes.  The index front ends read each wave's results and counters
back this way, so a wave synchronises with the card once.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

_NUMPY = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
          torch.uint8: np.uint8}


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors, flattened, as numpy arrays, read back in one copy.
    Give the widest dtypes first, so each array starts aligned."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) if t.numel() else
                      t.new_empty(0, dtype=torch.uint8)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].view(_NUMPY[t.dtype]))
        at += n
    return out


__all__ = ["to_host"]
