"""Plain PyTorch versions of the WKV6 kernel and of its gradient.

``wkv6_plain`` is the step-by-step recurrence of the JAX package's
``kernels/rwkv6_scan/ref.py`` ``wkv6_ref`` in fp32, in the model's
layout ([B, T, H, dh], every head at once) and with the state carried
in and out, as ``csrc/wkv6.cu`` computes it:

    o_t = r_t . (S + u (x) k_t^T v_t);   S <- diag(exp(w_t)) S + k_t^T v_t

``wkv6_bwd_plain`` is its gradient, the explicit reverse recurrence in
fp32, as ``csrc/wkv6_bwd.cu`` computes it: with G the adjoint of the
state after step t (the final state's gradient at t = T),

    dr_t = (S_{t-1} + u (x) k_t^T v_t) do_t
    dk_t = G v_t + r_t (x) u (v_t . do_t)
    dv_t = G^T k_t + (r_t . (u (x) k_t)) do_t
    dlogw_t = w_t (x) sum_v (G (x) S_{t-1})
    du = sum_{b, t} r_t (x) k_t (v_t . do_t)
    G <- diag(w_t) G + r_t^T do_t

and the input state's gradient is the last G.  It walks the two
recurrences step by step, keeping every S_{t-1} and every G (a state
cannot be recovered from the next one by dividing by w_t, which
underflows to 0 in fp32 once logw falls below about -87), then forms
every step's terms at once.

The tests and the CPU path run both; on the card the kernels run
instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _acc(t: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: fp32, or float64 for
    float64 inputs (so that finite differences can check them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: [B, T, H, dh]; logw: [B, T, H, dh] log decay (<= 0);
    u: [H, dh] bonus; state: [B, H, dh_k, dh_v] fp32, zeros when None.
    Returns (o [B, T, H, dh] in r's dtype, final state fp32; float64
    throughout for float64 inputs)."""
    B, T, H, dh = r.shape
    acc = _acc(r)
    S = (torch.zeros(B, H, dh, dh, dtype=acc, device=r.device)
         if state is None else state.to(acc).clone())
    rf, kf, vf = r.to(acc), k.to(acc), v.to(acc)
    w = logw.to(acc).exp()
    uf = u.to(acc)[None, :, :, None]
    out = torch.empty(B, T, H, dh, dtype=acc, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B, H, dk, dv]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv)
        S = w[:, t, :, :, None] * S + kv
    return out.to(r.dtype), S


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                   state: Optional[torch.Tensor] = None,
                   dstate: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_plain`` from the output's gradient ``do``
    [B, T, H, dh] and the final state's, ``dstate`` [B, H, dh, dh] fp32
    (zeros when None).  Returns (dr, dk, dv in their inputs' dtypes,
    dlogw [B, T, H, dh] fp32, du [H, dh] fp32, and the input state's
    gradient [B, H, dh, dh] fp32, or None when ``state`` is None; float64
    throughout for float64 inputs)."""
    B, T, H, dh = r.shape
    dev, acc = r.device, _acc(r)
    rf, kf, vf, dof = (t.to(acc).transpose(0, 1) for t in (r, k, v, do))
    w = logw.to(acc).exp().transpose(0, 1)  # [T, B, H, dh]
    uf = u.to(acc)
    # the recurrences, one step at a time: S_{t-1} (before[t]) forwards,
    # then G_t (adjoint[t]) backwards
    before = torch.empty(T, B, H, dh, dh, dtype=acc, device=dev)
    adjoint = torch.empty(T, B, H, dh, dh, dtype=acc, device=dev)
    S = (torch.zeros(B, H, dh, dh, dtype=acc, device=dev)
         if state is None else state.to(acc).clone())
    for t in range(T):
        before[t] = S
        S = w[t, ..., None] * S + kf[t, ..., None] * vf[t, ..., None, :]
    G = (torch.zeros(B, H, dh, dh, dtype=acc, device=dev)
         if dstate is None else dstate.to(acc).clone())
    for t in reversed(range(T)):
        adjoint[t] = G
        G = w[t, ..., None] * G + rf[t, ..., None] * dof[t, ..., None, :]
    # the terms of every step at once
    vdo = (vf * dof).sum(-1, keepdim=True)  # [T, B, H, 1]
    dr = torch.einsum("tbhkv,tbhv->tbhk", before, dof) + uf * kf * vdo
    dk = torch.einsum("tbhkv,tbhv->tbhk", adjoint, vf) + rf * uf * vdo
    dv = torch.einsum("tbhkv,tbhk->tbhv", adjoint, kf) \
        + (rf * uf * kf).sum(-1, keepdim=True) * dof
    dlogw = w * (adjoint * before).sum(-1)
    du = (rf * kf * vdo).sum((0, 1))
    dr, dk, dv, dlogw = (t.transpose(0, 1).contiguous()
                         for t in (dr, dk, dv, dlogw))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du,
            G if state is not None else None)


__all__ = ["wkv6_bwd_plain", "wkv6_plain"]
