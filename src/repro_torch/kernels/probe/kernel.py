"""The chained probe kernel's wrapper (``csrc/probe.cu``).

``probe_chain`` is the port's form of the JAX package's
``kernels/probe/kernel.py`` ``probe64_fp`` (``use_fp=True``) and
``probe64`` (``use_fp=False``), with the chain-window gather of
``kernels/clht_probe/ops.py::_gather_probe`` folded into the kernel:
it reads the snapshot's line table (``layout.pack_lines``), built once
an epoch.
On CUDA tensors it launches the CUDA kernel on the current stream, or
raises; on CPU tensors it runs ``ref.probe_chain_plain``.  Nothing else
selects between the two.

``LAUNCHES`` counts kernel launches per variant, under the TPU
kernels' names; a call on CPU tensors launches nothing and counts
nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ... import build
from .layout import LINE_WORDS
from .ref import probe_chain_plain

#: CUDA launches per kernel variant since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"probe64_fp": 0, "probe64": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p

#: the line table's alignment: the kernel reads it in 16-byte vectors,
#: and each line is one 64-byte segment
ALIGN = 64


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("probe")
    lib.probe_chain.argtypes = [_P] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [_P] * 5
    lib.probe_chain.restype = ctypes.c_int
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _check(queries, bucket, lines, depth) -> None:
    if queries.dim() != 1 or lines.dim() != 2:
        raise ValueError("queries must be [Q] and lines [L, 8]")
    n_q = queries.shape[0]
    dev = queries.device
    for name, t, dtype, shape in (
            ("queries", queries, torch.int64, (n_q,)),
            ("bucket", bucket, torch.int64, (n_q,)),
            ("lines", lines, torch.int64, (lines.shape[0], LINE_WORDS))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lines.data_ptr() % ALIGN:
        raise ValueError(f"lines must be {ALIGN}-byte aligned")
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")


def probe_chain(queries: torch.Tensor, bucket: torch.Tensor,
                lines: torch.Tensor, depth: int, *, use_fp: bool
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Probe ``depth`` hops of each query's chain.

    queries, bucket: [Q] int64 (bucket = the row each query's probe
    starts at); lines: [L, 8] int64, the snapshot's line table from
    ``layout.pack_lines``, 64-byte aligned.  Returns (found [Q] bool,
    values [Q] int64, nfp [Q] int32, nfalse [Q] int32), the counts None
    when ``use_fp`` is off.  The outputs are bit-identical to
    ``probe_chain_plain`` on the same inputs."""
    _check(queries, bucket, lines, depth)
    dev = queries.device
    if dev.type == "cpu":
        return probe_chain_plain(queries, bucket, lines, depth,
                                 use_fp=use_fp)
    if dev.type != "cuda":
        raise ValueError(f"probe_chain takes CUDA or CPU tensors, not {dev}")
    n_q = queries.shape[0]
    found = torch.empty(n_q, dtype=torch.bool, device=dev)
    values = torch.empty(n_q, dtype=torch.int64, device=dev)
    nfp = nfalse = None
    if use_fp:
        nfp = torch.empty(n_q, dtype=torch.int32, device=dev)
        nfalse = torch.empty(n_q, dtype=torch.int32, device=dev)
    if n_q == 0:
        return found, values, nfp, nfalse
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.probe_chain(
            queries.data_ptr(), bucket.data_ptr(), lines.data_ptr(), n_q,
            lines.shape[0], int(depth), int(use_fp),
            found.data_ptr(), values.data_ptr(),
            nfp.data_ptr() if use_fp else None,
            nfalse.data_ptr() if use_fp else None, stream)
    if err:
        raise RuntimeError("probe_chain kernel launch failed: "
                           + lib.probe_error_string(err).decode())
    LAUNCHES["probe64_fp" if use_fp else "probe64"] += 1
    return found, values, nfp, nfalse


__all__ = ["ALIGN", "LAUNCHES", "probe_chain",
           "reset_launches"]
