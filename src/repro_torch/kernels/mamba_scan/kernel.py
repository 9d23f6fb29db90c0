"""The SSD kernels' wrappers: the scan (``csrc/ssd.cu``) and its
gradient (``csrc/ssd_bwd.cu``).

``ssd`` is the port's form of the JAX package's
``kernels/mamba_scan/kernel.py`` ``ssd``, in the model's layout: x
[B, T, H, dh], dt [B, T, H], B_ and C_ [B, T, N] shared by every head,
A [H] (the Pallas kernel takes [B*H, T, ...] rows with B_ and C_ copied
per head), with the state carried in and out, and any T (the Pallas
kernel asserts T % chunk == 0).  On CUDA tensors it launches the CUDA
kernels on the current stream, or raises; on CPU tensors it runs
``ref.ssd_plain``.  Nothing else selects between the two.  A bf16
prefill (T > 1) runs three CUDA kernels (chunk increments, the pass
over the chunks, the outputs) over a scratch this wrapper allocates;
T = 1 and fp32 run one.

``ssd_bwd`` computes (dx, ddt, dB_, dC_, dA, and the input state's
gradient) of that function from the output's gradient and, optionally,
the final state's.  No TPU kernel is its counterpart: the JAX package
trains the hybrid through XLA's autodiff of its jnp chunked form.  On
CUDA tensors it launches the CUDA kernels of its source over an fp32
scratch it allocates (``ssd_bwd_scratch_floats`` in the source), or
raises; on CPU tensors it runs ``ref.ssd_bwd_plain``.  A bf16 call with
T > 1 runs the chunk-parallel form on the tensor cores over 151 MB of
scratch at Jamba's full-width mixer shape: the adjoint's increments and
its reverse pass over the 64-step chunks, the chunks' gradients a group
of 8 heads a block, and the sums of dB_, dC_ over the groups and of dA
over the chunks, five kernels, with the states entering each chunk
taken from the forward's scratch where the caller kept it (``ssd(...,
keep_states=True)``, as ``ops.ssd_heads`` does), else recomputed by the
prefill's own two kernels; fp32 and T = 1 run the serial form (three
kernels, a checkpoint every 16 steps and the heads' dB_, dC_ partials:
403 MB at that shape).

Both refuse to run under grad with an input that requires it
(``grad_guard``): ``ops.ssd_heads`` is the differentiable op.

``LAUNCHES`` counts calls that launched the kernels, one a call however
many CUDA kernels it runs, under the TPU kernel's name and the
backward's under ``ssd_bwd``; a call on CPU tensors launches nothing
and counts nothing.  On ``meta`` tensors (the dry run) neither launches:
each charges its work (``analysis.roofline``'s ``ssd_work`` and
``ssd_bwd_work``) and returns outputs of the right shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ... import build
from ..grad_guard import refuse_grad
from .ref import ssd_bwd_plain, ssd_plain

#: CUDA launches since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"ssd": 0, "ssd_bwd": 0}

HEAD_DIMS = (32, 64, 128)  # the head widths the CUDA kernel is built for
STATE_DIMS = (8, 16)       # and the state widths
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ssd")
    lib.ssd.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.ssd.restype = _I
    lib.ssd_scratch_floats.argtypes = [_I] * 6
    lib.ssd_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_error_string.argtypes = [_I]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load("ssd_bwd")
    lib.ssd_bwd.argtypes = [_P] * 16 + [_I] * 6 + [_P]
    lib.ssd_bwd.restype = _I
    lib.ssd_bwd_scratch_floats.argtypes = [_I] * 6
    lib.ssd_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_bwd_error_string.argtypes = [_I]
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
           C_: torch.Tensor, A: torch.Tensor,
           state: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError("x must be [B, T, H, dh]")
    Bsz, T, H, dh = x.shape
    if dt.shape != (Bsz, T, H):
        raise ValueError(f"dt must be [B={Bsz}, T={T}, H={H}], got "
                         f"{tuple(dt.shape)}")
    if B_.dim() != 3 or B_.shape[:2] != (Bsz, T) or C_.shape != B_.shape:
        raise ValueError(f"B_ and C_ must be [B={Bsz}, T={T}, N] alike, got "
                         f"{tuple(B_.shape)} and {tuple(C_.shape)}")
    if A.shape != (H,):
        raise ValueError(f"A must be [H={H}], got {tuple(A.shape)}")
    N = B_.shape[-1]
    if state is not None and state.shape != (Bsz, H, dh, N):
        raise ValueError(f"state must be [B={Bsz}, H={H}, dh={dh}, N={N}], "
                         f"got {tuple(state.shape)}")
    for name, t in (("B_", B_), ("C_", C_)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    named = (("dt", dt), ("B_", B_), ("C_", C_), ("A", A))
    if state is not None:
        named += (("state", state),)
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _card_check(x: torch.Tensor, N: int, named) -> None:
    """Raise on what the CUDA kernels do not take: a head width outside
    ``HEAD_DIMS``, a state width outside ``STATE_DIMS``, a dtype outside
    ``DTYPES``, a float32 input (dt, A and the states) of another type, a
    strided input."""
    dh = x.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dh}")
    if N not in STATE_DIMS:
        raise ValueError(f"the CUDA kernel takes d_state in {STATE_DIMS}, "
                         f"got {N}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 x, B_, "
                        f"C_, got {x.dtype}")
    for name, t in named:
        if t is None:
            continue
        if name in _FP32 and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_FP32 = ("dt", "A", "state", "dstate")


def ssd(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
        C_: torch.Tensor, A: torch.Tensor,
        state: Optional[torch.Tensor] = None, keep_states: bool = False
        ) -> Tuple[torch.Tensor, ...]:
    """The SSD scan over T steps from ``state`` (zeros when None).

    x: [B, T, H, dh], float32 or bfloat16; dt: [B, T, H] float32, each
    entry 0 or more; B_, C_: [B, T, N] in x's dtype; A: [H] float32,
    each entry below 0; state: [B, H, dh, N] float32.  Returns
    (y [B, T, H, dh] in x's dtype, the final state [B, H, dh, N]
    float32); the input state is not written.  With ``keep_states`` a
    third item: the scratch of a bf16 prefill on the card (the states
    entering each 64-step chunk and the chunks' decays), which
    ``ssd_bwd`` takes as ``saved``, or None (the CPU, fp32, T = 1)."""
    _check(x, dt, B_, C_, A, state)
    refuse_grad("ssd", x, dt, B_, C_, A, state)
    dev = x.device
    if dev.type == "cpu":
        out = ssd_plain(x, dt, B_, C_, A, state)
        return out + (None,) if keep_states else out
    Bsz, T, H, dh = x.shape
    N = B_.shape[-1]
    if dev.type == "meta":  # the dry run: charge the work, launch nothing
        from ...analysis.roofline import charge, ssd_work
        charge("ssd", ssd_work(Bsz, T, H, dh, N, x.element_size(),
                               state is not None))
        out = (torch.empty_like(x), torch.empty(
            Bsz, H, dh, N, dtype=torch.float32, device=dev))
        return out + (None,) if keep_states else out
    if dev.type != "cuda":
        raise ValueError(f"ssd takes CUDA or CPU tensors, not {dev}")
    _card_check(x, N, (("x", x), ("dt", dt), ("B_", B_), ("C_", C_),
                       ("A", A), ("state", state)))
    # the state is read as float4s, a bf16 prefill's inputs by cp.async
    wide = (("state", state),) if state is not None else ()
    if x.dtype == torch.bfloat16 and T > 1:
        wide += (("x", x), ("B_", B_), ("C_", C_))
    for name, t in wide:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernels "
                             "read it in 16-byte pieces")
    y = torch.empty_like(x)
    state_out = torch.empty(Bsz, H, dh, N, dtype=torch.float32, device=dev)
    kept = (None,) if keep_states else ()
    if Bsz == 0 or H == 0:
        return (y, state_out) + kept
    if T == 0:
        if state is None:
            return (y, state_out.zero_()) + kept
        return (y, state_out.copy_(state)) + kept
    lib = _library()
    n_scratch = lib.ssd_scratch_floats(Bsz, T, H, dh, N, DTYPES[x.dtype])
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) \
        if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd(x.data_ptr(), dt.data_ptr(), B_.data_ptr(),
                      C_.data_ptr(), A.data_ptr(),
                      state.data_ptr() if state is not None else None,
                      y.data_ptr(), state_out.data_ptr(),
                      scratch.data_ptr() if scratch is not None else None,
                      Bsz, T, H, dh, N, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("ssd kernel launch failed: "
                           + lib.ssd_error_string(err).decode())
    LAUNCHES["ssd"] += 1
    return (y, state_out) + ((scratch,) if keep_states else ())


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
            C_: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
            state: Optional[torch.Tensor] = None,
            dstate: Optional[torch.Tensor] = None,
            saved: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd`` over the same inputs, from the output's
    gradient ``dy`` [B, T, H, dh] (x's dtype) and the final state's,
    ``dstate`` [B, H, dh, N] float32 (zeros when None, as a trainer that
    drops the final state leaves it).  ``saved``: the scratch that
    ``ssd(..., keep_states=True)`` returned on these inputs, from which a
    bf16 call of T > 1 on the card takes the states entering each chunk
    instead of recomputing them; ignored elsewhere.  Returns (dx in x's
    dtype, ddt [B, T, H] float32, dB_ and dC_ [B, T, N] in x's dtype,
    summed over heads, dA [H] float32, and the input state's gradient
    [B, H, dh, N] float32, or None when ``state`` is None)."""
    _check(x, dt, B_, C_, A, state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be x's shape, dtype and device, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    Bsz, T, H, dh = x.shape
    N = B_.shape[-1]
    if dstate is not None and (dstate.shape != (Bsz, H, dh, N)
                               or dstate.device != x.device):
        raise ValueError(f"dstate must be [B={Bsz}, H={H}, dh={dh}, N={N}] "
                         f"on {x.device}, got {tuple(dstate.shape)} on "
                         f"{dstate.device}")
    refuse_grad("ssd_bwd", x, dt, B_, C_, A, dy, state, dstate)
    dev = x.device
    if dev.type == "cpu":
        return ssd_bwd_plain(x, dt, B_, C_, A, dy, state, dstate)
    if dev.type == "meta":  # the dry run: charge the work, launch nothing
        from ...analysis.roofline import charge, ssd_bwd_work
        charge("ssd_bwd", ssd_bwd_work(Bsz, T, H, dh, N, x.element_size()))
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.empty_like(x), torch.empty(Bsz, T, H, **f32),
                torch.empty_like(B_), torch.empty_like(C_),
                torch.empty(H, **f32),
                None if state is None else torch.empty(Bsz, H, dh, N, **f32))
    if dev.type != "cuda":
        raise ValueError(f"ssd_bwd takes CUDA or CPU tensors, not {dev}")
    _card_check(x, N, (("x", x), ("dt", dt), ("B_", B_), ("C_", C_),
                       ("A", A), ("dy", dy), ("state", state),
                       ("dstate", dstate)))
    # a bf16 call of T > 1 loads its inputs by cp.async and reads the
    # carried state and the final state's gradient as float4s
    if x.dtype == torch.bfloat16 and T > 1:
        for name, t in (("x", x), ("B_", B_), ("C_", C_), ("dy", dy),
                        ("state", state), ("dstate", dstate)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned: the "
                                 "kernels read it in 16-byte pieces")
    dx = torch.empty_like(x)
    ddt = torch.empty(Bsz, T, H, dtype=torch.float32, device=dev)
    dB, dC = torch.zeros_like(B_), torch.zeros_like(C_)
    dA = torch.zeros(H, dtype=torch.float32, device=dev)
    dstate_in = None
    if state is not None:
        dstate_in = torch.empty(Bsz, H, dh, N, dtype=torch.float32,
                                device=dev)
    if Bsz == 0 or H == 0 or T == 0:
        if dstate_in is not None:
            if dstate is None:
                dstate_in.zero_()
            else:
                dstate_in.copy_(dstate)
        return dx, ddt, dB, dC, dA, dstate_in
    lib = _bwd_library()
    scratch = torch.empty(
        lib.ssd_bwd_scratch_floats(Bsz, T, H, dh, N, DTYPES[x.dtype]),
        dtype=torch.float32, device=dev)
    if not (x.dtype == torch.bfloat16 and T > 1):
        saved = None
    elif saved is not None:
        need = _library().ssd_scratch_floats(Bsz, T, H, dh, N,
                                             DTYPES[x.dtype])
        if (saved.device != dev or saved.dtype != torch.float32
                or saved.numel() < need or not saved.is_contiguous()):
            raise ValueError("saved must be the float32 scratch of ssd on "
                             "these inputs")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_bwd(ptr(x), ptr(dt), ptr(B_), ptr(C_), ptr(A),
                          ptr(state), ptr(dy), ptr(dstate), ptr(dx),
                          ptr(ddt), ptr(dB), ptr(dC), ptr(dA),
                          ptr(dstate_in), ptr(scratch), ptr(saved), Bsz, T,
                          H, dh, N, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError("ssd_bwd kernel launch failed: "
                           + lib.ssd_bwd_error_string(err).decode())
    LAUNCHES["ssd_bwd"] += 1
    return dx, ddt, dB, dC, dA, dstate_in


__all__ = ["DTYPES", "HEAD_DIMS", "LAUNCHES", "STATE_DIMS", "reset_launches",
           "ssd", "ssd_bwd"]
