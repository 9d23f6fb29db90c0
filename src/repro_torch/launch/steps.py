"""Step builders: the port of ``repro.launch.steps``'s step functions
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``).

A train step runs the loss forward and ``loss.backward()`` through the
port's kernels (attention forward and backward on the flash-attention
kernels, RWKV6's and Mamba's scans forward and backward on the WKV6 and
SSD kernels), then AdamW at the architecture's schedule (WSD for MiniCPM,
cosine otherwise) at step ``state.step + 1``; the model's parameters
are updated in place, where the JAX step returns new ones.

The rest of the JAX module (``batch_specs``, ``input_specs``,
``cell_shardings``, ``named_tree``, ``apply_variants`` with
``kv_int8``, ``lower_cell`` and ``group_probes``) builds and lowers the
production mesh's dry run, which is not ported yet (``launch/dryrun.py``
and the TPU roofline: ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models.model import LM
from ..optim import adamw, schedules
from ..optim.adamw import AdamWState


def make_train_step(model: LM, arch_name: str, *,
                    total_steps: int = 10_000) -> Callable:
    """``train_step(batch, opt_state) -> (loss, new opt_state)``:
    ``batch`` holds ``tokens`` and ``labels`` [B, T] (and Whisper's
    ``frames`` or InternVL's ``patches``); the loss is a 0-d fp32 tensor
    on the model's device, detached.  Turns the model's
    parameters trainable."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(batch: Dict[str, torch.Tensor], opt_state: AdamWState
                   ) -> Tuple[torch.Tensor, AdamWState]:
        for p in params.values():
            p.grad = None
        loss = model.loss(batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        lr = schedules.for_arch(arch_name, opt_state.step + 1,
                                total=total_steps)
        _, new_state = adamw.update(grads, opt_state, params, lr=lr)
        del grads
        for p in params.values():  # free the gradients before the next step
            p.grad = None
        return loss.detach(), new_state

    return train_step


def make_prefill_step(model: LM, seq_len: int) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch, seq_len)

    return prefill_step


def make_decode_step(model: LM, *, with_enc: bool = False) -> Callable:
    """``decode_step(token, caches, pos)``, or with ``with_enc``
    ``decode_step(token, caches, pos, enc)`` for the encoder-decoder
    family (Whisper), whose cross attention reads the encoder's output
    ``enc`` (``model._encode(frames)``)."""
    if with_enc:
        def decode_step(token, caches, pos, enc):
            return model.decode_step(token, caches, pos, enc=enc)
    else:
        def decode_step(token, caches, pos):
            return model.decode_step(token, caches, pos)
    return decode_step


__all__ = ["make_decode_step", "make_prefill_step", "make_train_step"]
