"""The WKV6 kernels' wrappers: the scan (``csrc/wkv6.cu``) and its
gradient (``csrc/wkv6_bwd.cu``).

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

``wkv6_bwd`` computes (dr, dk, dv, dlogw, du, and the input state's
gradient) of that function from the output's gradient and, optionally,
the final state's.  No TPU kernel is its counterpart: the JAX package
trains RWKV6 through XLA's autodiff of its jnp chunked form.  On CUDA
tensors it launches the CUDA kernels of its source over an fp32 scratch
it allocates (``wkv6_bwd_scratch_floats`` in the source), or raises; on
CPU tensors it runs ``ref.wkv6_bwd_plain``.  A bf16 call with T > 1
runs the chunk-parallel form on the tensor cores over 144 MB of
scratch at RWKV6-7B's training shape: the adjoint's increments and its
reverse pass over the 64-step chunks, the chunks' gradients and du's
sum, four kernels, with the states entering each chunk taken from the
forward's scratch where the caller kept it (``wkv6(...,
keep_states=True)``, as ``ops.wkv6_heads`` does), else recomputed by the
prefill's own two kernels; fp32 and T = 1 run the serial form (three
kernels, a checkpoint every 16 steps and the column slices' partials:
537 MB at that shape).

Both refuse to run under grad with an input that requires it
(``grad_guard``): ``ops.wkv6_heads`` is the differentiable op.

``LAUNCHES`` counts calls that launched the kernels, one a call however
many CUDA kernels it runs, under the TPU kernel's name and the
backward's under ``wkv6_bwd``; a call on CPU tensors launches nothing
and counts nothing.  On ``meta`` tensors (the dry run) neither launches:
each charges its work (``analysis.roofline``'s ``wkv6_work`` and
``wkv6_bwd_work``) and returns outputs of the right shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ... import build
from ..grad_guard import refuse_grad
from .ref import wkv6_bwd_plain, wkv6_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_bwd": 0}

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


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("wkv6_bwd")
    lib.wkv6_bwd.argtypes = [_P] * 17 + [_I] * 5 + [_P]
    lib.wkv6_bwd.restype = _I
    lib.wkv6_bwd_scratch_floats.argtypes = [_I] * 5
    lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_error_string.argtypes = [_I]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
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


def _card_check(r: torch.Tensor, named) -> None:
    """Raise on what the CUDA kernels do not take: a head width outside
    ``HEAD_DIMS``, a dtype outside ``DTYPES``, a float32 input (logw, u
    and the states) of another type, a strided input."""
    dh = r.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if r.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 r, k, "
                        f"v, got {r.dtype}")
    for name, t in named:
        if t is None:
            continue
        if name in _FP32 and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_FP32 = ("logw", "u", "state", "dstate")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None, keep_states: bool = False
         ) -> Tuple[torch.Tensor, ...]:
    """The RWKV6 WKV over T steps from ``state`` (zeros when None).

    r, k, v: [B, T, H, dh], float32 or bfloat16; logw: [B, T, H, dh]
    float32 log decay, each entry 0 or less; u: [H, dh] float32 bonus;
    state: [B, H, dh_k, dh_v] float32.  Returns (o [B, T, H, dh] in r's
    dtype, the final state [B, H, dh, dh] float32); the input state is
    not written.  With ``keep_states`` a third item: the scratch of a
    bf16 prefill on the card (the states entering each 64-step chunk and
    the chunks' decays), which ``wkv6_bwd`` takes as ``saved``, or None
    (the CPU, fp32, T = 1)."""
    _check(r, k, v, logw, u, state)
    refuse_grad("wkv6", r, k, v, logw, u, state)
    dev = r.device
    if dev.type == "cpu":
        out = wkv6_plain(r, k, v, logw, u, state)
        return out + (None,) if keep_states else out
    B, T, H, dh = r.shape
    if dev.type == "meta":  # the dry run: charge the work, launch nothing
        from ...analysis.roofline import charge, wkv6_work
        charge("wkv6", wkv6_work(B, T, H, dh, r.element_size(),
                                 state is not None))
        out = (torch.empty_like(r), torch.empty(
            B, H, dh, dh, dtype=torch.float32, device=dev))
        return out + (None,) if keep_states else out
    if dev.type != "cuda":
        raise ValueError(f"wkv6 takes CUDA or CPU tensors, not {dev}")
    _card_check(r, (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)))
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
    kept = (None,) if keep_states else ()
    if B == 0 or H == 0:
        return (out, state_out) + kept
    if T == 0:
        if state is None:
            return (out, state_out.zero_()) + kept
        return (out, state_out.copy_(state)) + kept
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
    return (out, state_out) + ((scratch,) if keep_states else ())


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
             state: Optional[torch.Tensor] = None,
             dstate: Optional[torch.Tensor] = None,
             saved: Optional[torch.Tensor] = None,
             final: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6`` over the same inputs, from the output's
    gradient ``do`` [B, T, H, dh] (r's dtype) and the final state's,
    ``dstate`` [B, H, dh, dh] float32 (zeros when None, as a trainer that
    drops the final state leaves it).  ``saved`` and ``final``: what
    ``wkv6(..., keep_states=True)`` returned on these inputs (its scratch
    and final state), from which a bf16 call of T > 1 on the card takes
    the states entering each chunk instead of recomputing them; ignored
    elsewhere.  Returns (dr, dk, dv in r's dtype, dlogw [B, T, H, dh]
    float32, du [H, dh] float32, and the input state's gradient
    [B, H, dh, dh] float32, or None when ``state`` is None)."""
    _check(r, k, v, logw, u, state)
    if do.shape != r.shape or do.dtype != r.dtype or do.device != r.device:
        raise ValueError(f"do must be r's shape, dtype and device, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    B, T, H, dh = r.shape
    if dstate is not None and (dstate.shape != (B, H, dh, dh)
                               or dstate.device != r.device):
        raise ValueError(f"dstate must be [B={B}, H={H}, dh, dh] on "
                         f"{r.device}, got {tuple(dstate.shape)} on "
                         f"{dstate.device}")
    refuse_grad("wkv6_bwd", r, k, v, logw, u, do, state, dstate)
    dev = r.device
    if dev.type == "cpu":
        return wkv6_bwd_plain(r, k, v, logw, u, do, state, dstate)
    if dev.type == "meta":  # the dry run: charge the work, launch nothing
        from ...analysis.roofline import charge, wkv6_bwd_work
        charge("wkv6_bwd", wkv6_bwd_work(B, T, H, dh, r.element_size()))
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty_like(r), torch.empty_like(r),
                torch.empty_like(r), torch.empty(B, T, H, dh, **f32),
                torch.empty(H, dh, **f32),
                None if state is None else torch.empty(B, H, dh, dh, **f32))
    if dev.type != "cuda":
        raise ValueError(f"wkv6_bwd takes CUDA or CPU tensors, not {dev}")
    _card_check(r, (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("do", do), ("state", state), ("dstate", dstate)))
    # a bf16 call of T > 1 loads its inputs by cp.async and reads the
    # carried state and the final state's gradient as float4s
    if r.dtype == torch.bfloat16 and T > 1:
        wide = (("r", r), ("k", k), ("v", v), ("logw", logw), ("do", do),
                ("state", state), ("dstate", dstate))
        for name, t in wide:
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned: the "
                                 "kernels read it in 16-byte pieces")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty(B, T, H, dh, dtype=torch.float32, device=dev)
    du = torch.zeros(H, dh, dtype=torch.float32, device=dev)
    dstate_in = None
    if state is not None:
        dstate_in = torch.empty(B, H, dh, dh, dtype=torch.float32,
                                device=dev)
    if B == 0 or H == 0 or T == 0:
        if dstate_in is not None:
            if dstate is None:
                dstate_in.zero_()
            else:
                dstate_in.copy_(dstate)
        return dr, dk, dv, dlogw, du, dstate_in
    lib = _bwd_library()
    scratch = torch.empty(
        lib.wkv6_bwd_scratch_floats(B, T, H, dh, DTYPES[r.dtype]),
        dtype=torch.float32, device=dev)
    chunked = r.dtype == torch.bfloat16 and T > 1
    if not chunked or saved is None:
        saved = final = None
    else:
        need = _library().wkv6_scratch_floats(B, T, H, dh, DTYPES[r.dtype])
        if (saved.device != dev or saved.dtype != torch.float32
                or saved.numel() < need or not saved.is_contiguous()
                or final is None or final.shape != (B, H, dh, dh)
                or final.device != dev or final.dtype != torch.float32
                or not final.is_contiguous()):
            raise ValueError("saved must be the float32 scratch of wkv6 on "
                             "these inputs and final its final state")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6_bwd(ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u),
                           ptr(state), ptr(do), ptr(dstate), ptr(dr),
                           ptr(dk), ptr(dv), ptr(dlogw), ptr(du),
                           ptr(dstate_in), ptr(scratch), ptr(saved),
                           ptr(final), B, T, H, dh, DTYPES[r.dtype], stream)
    if err:
        raise RuntimeError("wkv6_bwd kernel launch failed: "
                           + lib.wkv6_bwd_error_string(err).decode())
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dlogw, du, dstate_in


__all__ = ["DTYPES", "HEAD_DIMS", "LAUNCHES", "reset_launches", "wkv6",
           "wkv6_bwd"]
