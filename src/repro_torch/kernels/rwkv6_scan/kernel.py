"""The WKV6 kernel's wrapper (``csrc/wkv6.cu``).

``wkv6`` is the port's form of the JAX package's
``kernels/rwkv6_scan/kernel.py`` ``wkv6``, in the model's layout: r, k,
v and logw [B, T, H, dh], u [H, dh] (the Pallas kernel takes one head's
[B*H, T, dh] and its ops.py loops over heads), with the state carried
in and out, and any T (the Pallas kernel asserts T % chunk == 0).  On
CUDA tensors it launches the CUDA kernels on the current stream, or
raises; on CPU tensors it runs ``ref.wkv6_plain``.  Nothing else
selects between the two.  A bf16 prefill (T > 1) runs three CUDA
kernels (chunk increments, the pass over the chunks, the outputs) over
a scratch this wrapper allocates; T = 1 and fp32 run one.

``LAUNCHES`` counts calls that launched the kernels, one a call however
many CUDA kernels it runs, under the TPU kernel's name; a call on CPU
tensors launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ... import build
from ..grad_guard import refuse_grad
from .ref import wkv6_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"wkv6": 0}

HEAD_DIMS = (32, 64, 128)  # the head widths the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("wkv6")
    lib.wkv6.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.wkv6.restype = _I
    lib.wkv6_scratch_floats.argtypes = [_I] * 5
    lib.wkv6_scratch_floats.restype = ctypes.c_longlong
    lib.wkv6_error_string.argtypes = [_I]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           logw: torch.Tensor, u: torch.Tensor,
           state: Optional[torch.Tensor]) -> None:
    if r.dim() != 4:
        raise ValueError("r, k, v and logw must be [B, T, H, dh]")
    B, _, H, dh = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u must be [H={H}, dh={dh}], got {tuple(u.shape)}")
    if state is not None and state.shape != (B, H, dh, dh):
        raise ValueError(f"state must be [B={B}, H={H}, dh, dh], got "
                         f"{tuple(state.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    named = (("k", k), ("v", v), ("logw", logw), ("u", u))
    if state is not None:
        named += (("state", state),)
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 WKV over T steps from ``state`` (zeros when None).

    r, k, v: [B, T, H, dh], float32 or bfloat16; logw: [B, T, H, dh]
    float32 log decay, each entry 0 or less; u: [H, dh] float32 bonus;
    state: [B, H, dh_k, dh_v] float32.  Returns (o [B, T, H, dh] in r's
    dtype, the final state [B, H, dh, dh] float32); the input state is
    not written."""
    _check(r, k, v, logw, u, state)
    refuse_grad("wkv6", r, k, v, logw, u, state)
    dev = r.device
    if dev.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, state)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 takes CUDA or CPU tensors, not {dev}")
    B, T, H, dh = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if r.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 r, k, "
                        f"v, got {r.dtype}")
    for name, t in (("logw", logw), ("u", u)) + (
            (("state", state),) if state is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}, got "
                            f"{t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the state is read as float4s, a bf16 prefill's inputs by cp.async
    wide = (("state", state),) if state is not None else ()
    if r.dtype == torch.bfloat16 and T > 1:
        wide += (("r", r), ("k", k), ("v", v), ("logw", logw))
    for name, t in wide:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernels "
                             "read it in 16-byte pieces")
    out = torch.empty_like(r)
    state_out = torch.empty(B, H, dh, dh, dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return out, state_out
    if T == 0:
        if state is None:
            return out, state_out.zero_()
        return out, state_out.copy_(state)
    lib = _library()
    n_scratch = lib.wkv6_scratch_floats(B, T, H, dh, DTYPES[r.dtype])
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) \
        if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u.data_ptr(),
                       state.data_ptr() if state is not None else None,
                       out.data_ptr(), state_out.data_ptr(),
                       scratch.data_ptr() if scratch is not None else None,
                       B, T, H, dh, DTYPES[r.dtype], stream)
    if err:
        raise RuntimeError("wkv6 kernel launch failed: "
                           + lib.wkv6_error_string(err).decode())
    LAUNCHES["wkv6"] += 1
    return out, state_out


__all__ = ["DTYPES", "HEAD_DIMS", "LAUNCHES", "reset_launches", "wkv6"]
