"""Plain PyTorch versions of the SSD kernel and of its gradient.

``ssd_plain`` is the step-by-step selective-scan recurrence of the JAX
package's ``kernels/mamba_scan/ref.py`` ``ssd_ref`` in fp32, in the
model's layout (x [B, T, H, dh], B_ and C_ [B, T, N] shared by every
head) and with the state carried in and out, as ``csrc/ssd.cu``
computes it:

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;   y_t = h_t C_t

``ssd_bwd_plain`` is its gradient, the explicit reverse recurrence in
fp32, as ``csrc/ssd_bwd.cu`` computes it: with a_t = exp(dt_t A) and G
the adjoint of h_t, G_t = a_{t+1} G_{t+1} + dy_t^T C_t (the final
state's gradient entering at t = T - 1),

    dx_t = dt_t G_t B_t;   dC_t = sum_h h_t^T dy_t;
    dB_t = dt_t sum_h G_t^T x_t
    ddt_t = sum (G_t (x) x_t B_t^T) + A a_t sum (G_t (x) h_{t-1})
    dA = sum_{b, t} dt_t a_t sum (G_t (x) h_{t-1})

B_ and C_ are shared by every head, so their gradients sum over heads;
the input state's gradient is a_0 G_0.  It walks the two recurrences
step by step, keeping every state and every G, then forms every step's
terms at once, as the WKV6 gradient does.

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


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
              C_: torch.Tensor, A: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, H, dh]; dt: [B, T, H] (0 or more); B_, C_: [B, T, N];
    A: [H] (below 0); state: [B, H, dh, N] fp32, zeros when None.
    Returns (y [B, T, H, dh] in x's dtype, final state fp32; float64
    throughout for float64 inputs)."""
    Bsz, T, H, dh = x.shape
    N = B_.shape[-1]
    acc = _acc(x)
    h = (torch.zeros(Bsz, H, dh, N, dtype=acc, device=x.device)
         if state is None else state.to(acc).clone())
    xf, bf, cf = x.to(acc), B_.to(acc), C_.to(acc)
    dtf = dt.to(acc)
    decay = torch.exp(dtf * A.to(acc))  # [B, T, H]
    y = torch.empty(Bsz, T, H, dh, dtype=acc, device=x.device)
    for t in range(T):
        xdt = xf[:, t] * dtf[:, t, :, None]  # [B, H, dh]
        h = decay[:, t, :, None, None] * h \
            + xdt[..., None] * bf[:, t, None, None, :]
        y[:, t] = torch.einsum("bhdn,bn->bhd", h, cf[:, t])
    return y.to(x.dtype), h


def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  dstate: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_plain`` from the output's gradient ``dy``
    [B, T, H, dh] and the final state's, ``dstate`` [B, H, dh, N] fp32
    (zeros when None).  Returns (dx, ddt [B, T, H] fp32, dB_, dC_ [B, T,
    N], dA [H] fp32, and the input state's gradient [B, H, dh, N] fp32,
    or None when ``state`` is None); dx, dB_ and dC_ in x's dtype;
    float64 throughout for float64 inputs."""
    Bsz, T, H, dh = x.shape
    N = B_.shape[-1]
    dev, acc = x.device, _acc(x)
    xf, dyf = x.to(acc).transpose(0, 1), dy.to(acc).transpose(0, 1)
    bf, cf = B_.to(acc).transpose(0, 1), C_.to(acc).transpose(0, 1)
    dtf, Af = dt.to(acc).transpose(0, 1), A.to(acc)  # dt: [T, B, H]
    decay = torch.exp(dtf * Af)
    xdt = xf * dtf[..., None]  # [T, B, H, dh]
    # the recurrences, one step at a time: h_{t-1} and h_t (states[t],
    # states[t + 1]) forwards, then G_t (adjoint[t]) backwards
    states = torch.empty(T + 1, Bsz, H, dh, N, dtype=acc, device=dev)
    adjoint = torch.empty(T, Bsz, H, dh, N, dtype=acc, device=dev)
    states[0] = 0 if state is None else state.to(acc)
    for t in range(T):
        states[t + 1] = decay[t, ..., None, None] * states[t] \
            + xdt[t, ..., None] * bf[t, :, None, None, :]
    G = (torch.zeros(Bsz, H, dh, N, dtype=acc, device=dev)
         if dstate is None else dstate.to(acc).clone())
    for t in reversed(range(T)):
        G = G + dyf[t, ..., None] * cf[t, :, None, None, :]
        adjoint[t] = G
        G = decay[t, ..., None, None] * G
    # the terms of every step at once
    dC = torch.einsum("tbhdn,tbhd->tbn", states[1:], dyf)
    gb = torch.einsum("tbhdn,tbn->tbhd", adjoint, bf)
    dx = dtf[..., None] * gb
    dB = torch.einsum("tbhdn,tbhd->tbn", adjoint, xdt)
    gh = (adjoint * states[:-1]).sum((-2, -1))  # [T, B, H]
    ddt = (gb * xf).sum(-1) + Af * decay * gh
    dA = (dtf * decay * gh).sum((0, 1))
    dx, ddt, dB, dC = (t.transpose(0, 1).contiguous()
                       for t in (dx, ddt, dB, dC))
    return (dx.to(x.dtype), ddt, dB.to(x.dtype), dC.to(x.dtype), dA,
            G if state is not None else None)


__all__ = ["ssd_bwd_plain", "ssd_plain"]
