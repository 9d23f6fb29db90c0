"""Host front-end for plan-conflict detection.

``conflict_any`` is what ``distributed.StreamDriver`` calls to admit a
candidate plan against the plans a tick has already admitted: True
where a candidate op cannot share the tick with the set.  With
``device=None`` it is the host oracle ``conflict_any_ref``, as the JAX
package's default is; with a torch device it uploads both sets and
runs ``kernel.conflict_any`` there (the CUDA kernel on the card, its
plain PyTorch version on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...obs import RECORDER as _OBS
from .kernel import conflict_any as _conflict_any_kernel
from .ref import (DELETE, GET, PUT, SCAN, UPDATE, conflict_any_ref,
                  conflict_matrix_ref, is_write_kind, wave_levels_ref)


def conflict_any(kinds_a, keys_a, kinds_b, keys_b, *,
                 writes_conflict: bool = False,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """[A] bool: does each candidate op conflict with any reference op."""
    kinds_a = np.asarray(kinds_a, np.int32)
    kinds_b = np.asarray(kinds_b, np.int32)
    keys_a = np.asarray(keys_a, np.int64)
    keys_b = np.asarray(keys_b, np.int64)
    # the span's attributes are the JAX package's: ``use_kernel`` says
    # whether the check launches the kernel (on the card)
    on_card = device is not None and torch.device(device).type == "cuda"
    with _OBS.span("kernel.conflict", batch=int(kinds_a.size),
                   ref=int(kinds_b.size), use_kernel=on_card):
        if device is None or kinds_a.size == 0 or kinds_b.size == 0:
            return conflict_any_ref(kinds_a, keys_a, kinds_b, keys_b,
                                    writes_conflict=writes_conflict)
        ta = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (kinds_a, keys_a, kinds_b, keys_b)]
        return _conflict_any_kernel(
            *ta, writes_conflict=writes_conflict).cpu().numpy()


__all__ = ["DELETE", "GET", "PUT", "SCAN", "UPDATE", "conflict_any",
           "conflict_any_ref", "conflict_matrix_ref", "is_write_kind",
           "wave_levels_ref"]
