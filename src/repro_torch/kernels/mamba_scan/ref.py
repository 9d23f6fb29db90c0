"""Plain PyTorch version of the SSD kernel.

``ssd_plain`` is the step-by-step selective-scan recurrence of the JAX
package's ``kernels/mamba_scan/ref.py`` ``ssd_ref`` in fp32, in the
model's layout (x [B, T, H, dh], B_ and C_ [B, T, N] shared by every
head) and with the state carried in and out, as ``csrc/ssd.cu``
computes it:

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;   y_t = h_t C_t

The tests and the CPU path run it; on the card the kernel runs instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
              C_: torch.Tensor, A: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, H, dh]; dt: [B, T, H] (0 or more); B_, C_: [B, T, N];
    A: [H] (below 0); state: [B, H, dh, N] fp32, zeros when None.
    Returns (y [B, T, H, dh] in x's dtype, final state fp32)."""
    Bsz, T, H, dh = x.shape
    N = B_.shape[-1]
    h = (torch.zeros(Bsz, H, dh, N, dtype=torch.float32, device=x.device)
         if state is None else state.float().clone())
    xf, bf, cf = x.float(), B_.float(), C_.float()
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())  # [B, T, H]
    y = torch.empty(Bsz, T, H, dh, dtype=torch.float32, device=x.device)
    for t in range(T):
        xdt = xf[:, t] * dtf[:, t, :, None]  # [B, H, dh]
        h = decay[:, t, :, None, None] * h \
            + xdt[..., None] * bf[:, t, None, None, :]
        y[:, t] = torch.einsum("bhdn,bn->bhd", h, cf[:, t])
    return y.to(x.dtype), h


__all__ = ["ssd_plain"]
