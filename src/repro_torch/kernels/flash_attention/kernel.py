"""The flash-attention kernels' wrappers: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``).

``flash_attention`` is the port's form of the JAX package's
``kernels/flash_attention/kernel.py`` ``flash_attention``, in the
model's layout: q [B, T, H, dh], k and v [B, S, Hk, dh] (the Pallas
kernel takes [B*H, T, dh] with the kv heads already repeated; here the
kernel reads kv head h // (H // Hk) for query head h).  On CUDA tensors
it launches the CUDA kernel on the current stream, or raises; on CPU
tensors it runs ``ref.attention_plain``.  Nothing else selects between
the two.  The CUDA source holds one kernel per dtype: bfloat16 runs on
the tensor cores (wgmma, its tiles loaded by TMA), float32 on the CUDA
cores in exact fp32.

With ``return_lse`` the forward also returns each row's log-sum-exp
[B, H, T] (fp32, natural-log units, +inf where a row sees no key);
without it the kernel stores nothing more.

``flash_attention_bwd`` computes (dq, dk, dv) of that function from
the forward's output, its LSE and the output's gradient.  No TPU kernel
is its counterpart: the JAX package trains through XLA's autodiff of
its jnp attention.  On CUDA tensors it launches the CUDA kernels of its
source (two, or three in bf16 where a kv head serves several query
heads; counted as one launch a call) over an fp32 scratch it allocates
(``flash_attention_bwd_scratch_floats`` in the source: at most 2 x B S
H dh floats of dk and dv partials, 54 MB at StarCoder2-15B's heads over
T = 1100), or raises; on CPU tensors it runs
``ref.attention_bwd_plain``, which rebuilds P itself.

``LAUNCHES`` counts kernel launches under the TPU kernel's name and
the backward's under ``flash_attention_bwd``; a call on CPU tensors
launches nothing and counts nothing.  On ``meta`` tensors (the dry run)
neither launches: each charges its work (``analysis.roofline``'s
``flash_work`` and ``flash_bwd_work``) and returns outputs of the right
shapes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from ... import build
from .ref import attention_bwd_plain, attention_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (32, 64, 128)  # the head widths the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P]
    lib.flash_attention.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = ([_P] * 10 + [_I] * 9
                                        + [ctypes.c_float, _P])
    lib.flash_attention_bwd.restype = _I
    lib.flash_attention_bwd_scratch_floats.argtypes = [_I] * 7
    lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.flash_attention_bwd_error_string.argtypes = [_I]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be [B, T, H, dh] and k, v [B, S, Hk, dh]")
    B, _, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k and v must be [B={B}, S, Hk, dh={dh}] alike, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    Hk = k.shape[2]
    if Hk < 1 or H % Hk:
        raise ValueError(f"{H} query heads are not a multiple of {Hk} kv "
                         "heads")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive width, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """Attention forward with online softmax over tiles of keys.

    q: [B, T, H, dh]; k, v: [B, S, Hk, dh], H % Hk == 0; float32 or
    bfloat16, accumulated in fp32.  Causal masking right-aligns the
    queries (query i at position i + S - T); ``window`` limits each
    query to its last ``window`` keys (causal only, as in the Pallas
    kernel).  Returns [B, T, H, dh] in q's dtype; rows that see no key
    are 0.  With ``return_lse``, returns (out, lse): lse [B, H, T] fp32,
    each row's log-sum-exp of its scaled scores (+inf where it sees no
    key), the input of ``flash_attention_bwd``."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               return_lse=return_lse)
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if dev.type == "meta":
        from ...analysis.roofline import charge, flash_work, seen_pairs
        pairs = seen_pairs(T, S, window) if causal else T * S
        charge("flash_attention", flash_work(B, T, S, H, Hk, dh, pairs,
                                             q.element_size(), return_lse))
        out = torch.empty_like(q)
        if return_lse:
            return out, torch.empty((B, H, T), dtype=torch.float32,
                                    device=dev)
        return out
    if dev.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA or CPU tensors, "
                         f"not {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if B * H > 65535:
        raise ValueError(f"batch * heads = {B * H} exceeds the grid's 65535")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned: the bf16 "
                                 "kernel loads its tiles by TMA")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0 or T == 0:
        return (out, lse) if return_lse else out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, T, S, H, Hk, dh,
            int(causal), int(window or 0), DTYPES[q.dtype],
            1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    B, T, H, _ = q.shape
    want = torch.float64 if q.dtype == torch.float64 else torch.float32
    if lse.dtype != want:
        raise TypeError(f"lse is {lse.dtype}, not {want}")
    if tuple(lse.shape) != (B, H, T):
        raise ValueError(f"lse is {tuple(lse.shape)}, not [B, H, T] = "
                         f"{(B, H, T)}")
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, q on {q.device}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        causal: bool = True, window: Optional[int] = None):
    """The gradient of ``flash_attention`` at (q, k, v).

    q, out, dout: [B, T, H, dh]; k, v: [B, S, Hk, dh]; one dtype, float32
    or bfloat16 on the card, contiguous (and 16-byte aligned in bf16).
    ``out`` and ``lse`` are the forward's output and log-sum-exp as it
    returned them (``flash_attention(..., return_lse=True)``): D =
    rowsum(dout * out) reads the first, P = exp(s - lse) the second.
    The card needs ``lse``; on the CPU it is checked and not read (the
    plain version rebuilds P).  Returns (dq, dk, dv) in q's dtype,
    accumulated in fp32; rows that see no key add nothing."""
    _check(q, k, v, window)
    if lse is not None:
        _check_lse(lse, q)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, q is "
                             f"{tuple(q.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = q.device
    if dev.type == "cpu":
        return attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                   window=window)
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if dev.type == "meta":
        from ...analysis.roofline import charge, flash_bwd_work, seen_pairs
        pairs = seen_pairs(T, S, window) if causal else T * S
        charge("flash_attention_bwd", flash_bwd_work(
            B, T, S, H, Hk, dh, pairs, q.element_size()))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd takes CUDA or CPU tensors, "
                         f"not {dev}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid's 65535")
    if lse is None:
        raise ValueError("the CUDA kernel reads the forward's lse: pass "
                         "flash_attention(..., return_lse=True)'s")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                        ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned: the bf16 "
                                 "kernels load their tiles by TMA")
    if B == 0 or T == 0 or S == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq = torch.empty_like(q)  # the kernels write every element
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_library()
    dtype = DTYPES[q.dtype]
    scratch = torch.empty(
        lib.flash_attention_bwd_scratch_floats(B, T, S, H, Hk, dh, dtype),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), B, T, S, H, Hk, dh,
            int(causal), int(window or 0), dtype, 1.0 / math.sqrt(dh),
            stream)
    if err:
        raise RuntimeError(
            "flash_attention_bwd kernel launch failed: "
            + lib.flash_attention_bwd_error_string(err).decode())
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


__all__ = ["DTYPES", "HEAD_DIMS", "LAUNCHES", "flash_attention",
           "flash_attention_bwd", "reset_launches"]
