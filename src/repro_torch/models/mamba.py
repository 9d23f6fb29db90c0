"""Mamba block in the SSD (state-space duality) form: the port of
``repro.models.mamba``.

Per head, with the [dh, N] state h and a scalar decay per head,

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;   y_t = h_t C_t

B_ and C_ are shared by every head.  The JAX package computes the scan
over a sequence with the jnp chunked form (``_ssd_chunked``) and in
decode with a one-step update.  The port runs both on the SSD kernel
(``kernels.mamba_scan.ssd_heads``): over the prompt from a zero state,
and in decode at T = 1 from the carried ``ssm`` state, one launch per
layer per step; in training ``ssd_heads``' backward runs the SSD
gradient kernel (``ssd_bwd``), one launch per layer per step.  On the
card those are the CUDA kernels, on the CPU their plain PyTorch
versions.  The kernel keeps the scan in fp32 and rounds
the output once, where ``_ssd_chunked`` rounds its in-chunk terms to
the activations' dtype: in fp32 the two agree, in bf16 they differ by
bf16 rounding.  Decode hands the kernel fp32 inputs, so its output, the
D term and the conv stay in fp32 until the gate, as the JAX one-step
update keeps them.

Parameter names and dtypes are the JAX package's: bf16 projections and
conv, fp32 ``dt_bias``, ``A_log`` and ``D``.  The projections are
``torch.matmul`` and the depthwise causal conv plain torch, as the JAX
package leaves both to XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ssd_heads
from .common import (dense_init, is_placed, keep_grad, local_heads,
                     merge_heads, reduce_like, split_heads)

Params = Dict[str, torch.Tensor]


def init_mamba(gen: torch.Generator, cfg) -> Params:
    m = cfg.mamba
    d = cfg.d_model
    d_in = m.expand * d
    H = d_in // m.head_dim
    dev = gen.device

    def full(value):
        return torch.full((H,), value, dtype=torch.float32, device=dev)

    return {
        "w_in": dense_init(gen, (d, 2 * d_in)),  # x and gate z
        "w_conv": dense_init(gen, (m.d_conv, d_in), scale=0.5),
        "w_bc": dense_init(gen, (d_in, 2 * m.d_state)),
        "w_dt": dense_init(gen, (d_in, H)),
        "dt_bias": full(0.0),
        "A_log": full(0.0),  # A = -exp(A_log)
        "D": full(1.0),
        "w_out": dense_init(gen, (d_in, d)),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, kernel size K.  x: [B, T, D], w: [K, D];
    the sum in x's dtype, tap by tap, as the JAX package adds it."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + T] * w[i]
    return out


def _ssm_inputs(p: Params, xs: torch.Tensor):
    """B_, C_ [..., N] in xs's dtype, dt [..., H] fp32 and A [H] fp32
    from the conv output ``xs`` [..., d_in], contiguous as the SSD
    kernel takes them."""
    B_, C_ = torch.matmul(xs, p["w_bc"]).chunk(2, dim=-1)
    dt = F.softplus(reduce_like(torch.matmul(xs, p["w_dt"]), p["dt_bias"])
                    .float() + p["dt_bias"])
    return (B_.contiguous(), C_.contiguous(), dt.contiguous(),
            -torch.exp(p["A_log"]))


# (batch, heads) dimensions of ssd_heads' x [B, T, H, dh], dt [B, T, H],
# B_ and C_ [B, T, N], A [H] (and a state [B, H, dh, N]), and of its y
# and final state
_SSD_DIMS = ((0, 2), (0, 2), (0, None), (0, None), (None, 0))
_SSD_OUT = ((0, 2), (0, 1))


def mamba_forward(p: Params, x: torch.Tensor, cfg, *,
                  return_state: bool = False):
    """Prefill over x [B, T, D] from a zero state.  With
    ``return_state`` also returns {"ssm": [B, H, dh, N] fp32, "conv":
    the last K - 1 pre-conv inputs [B, K - 1, d_in]}."""
    m = cfg.mamba
    T, D = x.shape[1:]
    d_in = m.expand * D
    H = d_in // m.head_dim
    xz = torch.matmul(x, p["w_in"])
    if is_placed(xz):
        # sharded on its columns over "model", as w_in is; x and z each
        # lie on half of the shards, so slicing them gathers xz, and the
        # slices' gradient would come back whole and make w_in's whole:
        # keep_grad returns it at xz's placements
        xz = keep_grad(xz)
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xs = F.silu(_conv1d(xs, p["w_conv"]))
    B_, C_, dt, A = _ssm_inputs(p, xs)
    xh = split_heads(xs, H, m.head_dim).contiguous()
    y, final = local_heads(ssd_heads, (xh, dt, B_, C_, A), _SSD_DIMS,
                           _SSD_OUT)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = merge_heads(y) * F.silu(z)
    out = torch.matmul(y, p["w_out"])
    if return_state:
        # decode resumes the conv with the last K - 1 pre-conv inputs
        pre = F.pad(xz[..., :d_in], (0, 0, m.d_conv - 1, 0))
        return out, {"ssm": final, "conv": pre[:, T:T + m.d_conv - 1]}
    return out


def init_mamba_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Params:
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    H = d_in // m.head_dim
    return {
        "ssm": torch.zeros(batch, H, m.head_dim, m.d_state,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, m.d_conv - 1, d_in, dtype=dtype,
                            device=device),
    }


def mamba_decode(p: Params, x: torch.Tensor, state: Params, cfg
                 ) -> Tuple[torch.Tensor, Params]:
    """One token from the carried state: the SSD kernel at T = 1 from
    ``state["ssm"]``.  x: [B, 1, D].  Returns (out [B, 1, D],
    {"ssm", "conv"}), new tensors."""
    m = cfg.mamba
    Bsz, _, D = x.shape
    d_in = m.expand * D
    H = d_in // m.head_dim
    xz = torch.matmul(x, p["w_in"])
    xs, z = xz[:, 0, :d_in], xz[:, 0, d_in:]
    # causal conv over [conv tail ++ xs], in fp32
    wdt = torch.promote_types(state["conv"].dtype, xs.dtype)
    window = torch.cat([state["conv"].to(wdt), xs[:, None].to(wdt)], dim=1)
    conv = torch.einsum("bkd,kd->bd", window.float(), p["w_conv"].float())
    h = F.silu(conv).to(x.dtype)
    B_, C_, dt, A = _ssm_inputs(p, h)
    # on the card the conv's einsum may leave h strided: the kernel
    # takes contiguous rows
    xh = split_heads(h, H, m.head_dim)[:, None].float().contiguous()
    y, ssm = local_heads(ssd_heads, (xh, dt[:, None], B_.float()[:, None],
                                     C_.float()[:, None], A, state["ssm"]),
                         _SSD_DIMS + ((0, 1),), _SSD_OUT)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(Bsz, d_in).to(x.dtype) * F.silu(z)
    out = torch.matmul(y, p["w_out"])[:, None]
    return out, {"ssm": ssm,
                 "conv": window[:, 1:].to(state["conv"].dtype)}


__all__ = ["init_mamba", "init_mamba_state", "mamba_decode",
           "mamba_forward"]
