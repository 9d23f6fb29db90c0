"""The 32-bit tag probe kernel's wrapper (``csrc/clht_probe.cu``).

``clht_probe`` is the port of the JAX package's
``kernels/clht_probe/kernel.py`` ``clht_probe``: int32 queries [Q]
against their pre-gathered int32 windows [Q, W], returning whether each
query hit and the first hit's value (0 where none did).  The Pallas
kernel asserts Q % 256 == 0; here Q takes any value.  On CUDA tensors
it launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.probe_plain``.  Nothing else selects between the
two.

``LAUNCHES`` counts kernel launches under the TPU kernel's name; a call
on CPU tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import build
from .ref import probe_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"clht_probe": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("clht_probe")
    lib.clht_probe.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    lib.clht_probe.restype = _I
    lib.clht_probe_error_string.argtypes = [_I]
    lib.clht_probe_error_string.restype = ctypes.c_char_p
    return lib


def clht_probe(queries: torch.Tensor, bucket_keys: torch.Tensor,
               bucket_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries: [Q] int32; bucket_keys, bucket_vals: [Q, W] int32.
    Returns (found [Q] bool, values [Q] int32)."""
    if queries.dim() != 1 or bucket_keys.dim() != 2 or \
            bucket_keys.shape != bucket_vals.shape or \
            bucket_keys.shape[0] != queries.shape[0]:
        raise ValueError(f"queries must be [Q] and the windows [Q, W] "
                         f"alike, got {tuple(queries.shape)}, "
                         f"{tuple(bucket_keys.shape)} and "
                         f"{tuple(bucket_vals.shape)}")
    for name, t in (("queries", queries), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
    dev = queries.device
    if dev.type == "cpu":
        return probe_plain(queries, bucket_keys, bucket_vals)
    if dev.type != "cuda":
        raise ValueError(f"clht_probe takes CUDA or CPU tensors, not {dev}")
    for name, t in (("queries", queries), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_q, width = bucket_keys.shape
    found = torch.empty(n_q, dtype=torch.bool, device=dev)
    values = torch.empty(n_q, dtype=torch.int32, device=dev)
    if n_q == 0:
        return found, values
    if width == 0:
        return found.zero_(), values.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.clht_probe(queries.data_ptr(), bucket_keys.data_ptr(),
                             bucket_vals.data_ptr(), found.data_ptr(),
                             values.data_ptr(), n_q, width, stream)
    if err:
        raise RuntimeError("clht_probe kernel launch failed: "
                           + lib.clht_probe_error_string(err).decode())
    LAUNCHES["clht_probe"] += 1
    return found, values


__all__ = ["LAUNCHES", "clht_probe", "reset_launches"]
