"""Learning-rate schedules: the port of ``repro.optim.schedules``.  WSD
(warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395 §4):
minicpm-2b trains with it, every other architecture with cosine.  Each
returns a 0-d fp32 tensor on the CPU, computed in fp32 as the JAX
package computes it."""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1) -> torch.Tensor:
    """MiniCPM warmup-stable-decay: linear warmup, flat stable phase,
    cosine-shaped decay to final_frac * peak."""
    step = _t(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    in_decay = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0,
                           1.0)
    decay_mult = final_frac + (1 - final_frac) * 0.5 * \
        (1 + torch.cos(math.pi * in_decay))
    return torch.where(step < warmup, warm, peak_lr * decay_mult)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> torch.Tensor:
    step = _t(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    mult = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                              * frac))
    return torch.where(step < warmup, warm, peak_lr * mult)


def for_arch(arch_name: str, step, peak_lr: float = 3e-4,
             total: int = 10000) -> torch.Tensor:
    if arch_name.startswith("minicpm"):
        return wsd(step, peak_lr=peak_lr, warmup=total // 100,
                   stable=int(total * 0.9), decay=total // 10)
    return cosine(step, peak_lr=peak_lr, warmup=total // 100, total=total)


__all__ = ["cosine", "for_arch", "wsd"]
