"""Training driver: the port of ``repro.launch.train``.

Every layer of the substrate in one loop:
  data pipeline (resumable cursor)  ->  train step (forward, backward on
  the attention and scan kernels, each layer's forward recomputed in the
  backward under the model's ``remat="full"``, AdamW + WSD)  ->  RECIPE
  checkpoint store (atomic generation commit)  ->  fleet monitor
  (heartbeats, stragglers)

``kill_at_step`` power-fails the metadata plane mid-run and then
RESTARTS from the last committed generation and the exact data cursor
(no recovery log).

The JAX driver trains the reduced configuration on the CPU; the port
trains on the card by default (``device="cpu"`` runs the plain kernel
versions), reduced by default as there, or at full width with
``reduced=False``, with weights drawn at random from ``seed``.  A
configuration whose training state (16 bytes a parameter: bf16 weights
and gradients, fp32 moments and master copy) does not fit one card is
refused at full width before anything is allocated.  Every decoder-only
family trains (attention, RWKV6, and the Mamba + attention + MoE
hybrid).  Whisper and InternVL are refused before any weight is drawn
(``check_token_batches``): the token pipeline feeds tokens only, as the
JAX ``train()`` does; they train at model level (``make_train_step``
on a batch with ``frames`` or ``patches``).  The checkpoint store
holds a leaf of at most 65,528 words (the JAX store's limit too), so a
full-width model cannot be checkpointed: run it for fewer steps than
``ckpt_every``.

Run ``python -m repro_torch.launch.train`` with ``PYTHONPATH=src``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint.store import CheckpointStore
from ..configs.base import get_arch
from ..convert import lm_arrays_from_params, lm_params_from_arrays
from ..core import PMem
from ..data.pipeline import DataConfig, TokenPipeline
from ..models.model import build_model, check_ported, takes_front_inputs
from ..optim import adamw
from .elastic import FleetMonitor
from .serve import CARD_BYTES
from .steps import make_train_step

TRAIN_BYTES_PER_PARAM = 16  # bf16 weights + grads, fp32 m, v and master


def check_fits_training(cfg) -> None:
    """Raise for a configuration whose training state does not fit one
    card: ``TRAIN_BYTES_PER_PARAM`` bytes a parameter (MiniCPM-2B: 3.0 B
    parameters, 48.1 GB; StarCoder2-15B: 16.0 B, 256 GB)."""
    n = cfg.param_count()
    need = TRAIN_BYTES_PER_PARAM * n
    if need > CARD_BYTES:
        raise NotImplementedError(
            f"training {cfg.name} at full width does not fit one card: "
            f"{n:,} parameters at {TRAIN_BYTES_PER_PARAM} bytes each are "
            f"{need / 1e9:.1f} GB against the card's "
            f"{CARD_BYTES / 1e9:.0f} GB; train it with reduced=True")


def check_token_batches(cfg) -> None:
    """Raise for Whisper and InternVL, whose batches need ``frames`` or
    ``patches`` beside the tokens."""
    if takes_front_inputs(cfg):
        raise NotImplementedError(
            f"train() does not train {cfg.name} ({cfg.family}): the token "
            "pipeline feeds tokens only, as the JAX train() does, with no "
            "frames or patches; train it at model level (make_train_step "
            "on a batch that holds them)")


def train(arch: str = "minicpm-2b", *, steps: int = 50, reduced: bool = True,
          batch: int = 8, seq_len: int = 64, ckpt_every: int = 10,
          kill_at_step: Optional[int] = None, seed: int = 0,
          pmem: Optional[PMem] = None, verbose: bool = True, device=None):
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    check_token_batches(cfg)
    check_ported(cfg)
    if not reduced:
        check_fits_training(cfg)
    model = build_model(cfg, seed=seed, device=device, remat="full")
    pmem = pmem or PMem()
    store = CheckpointStore(pmem, device=model.device)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                    global_batch=batch, n_docs=256,
                                    mean_doc_len=128, seed=seed), pmem=pmem,
                         device=model.device)
    monitor = FleetMonitor(n_workers=1)
    step_fn = make_train_step(model, cfg.name, total_steps=steps)
    params = dict(model.named_parameters())

    # ---- restart-or-init from the last committed generation ----------
    latest = store.latest_step()
    if latest is not None:
        tree = store.restore(lm_arrays_from_params(params, cfg), step=latest)
        model.load_state_dict(lm_params_from_arrays(tree, cfg))
        start = data.global_step
        if verbose:
            print(f"[train] restored generation step={latest}, "
                  f"data cursor={data.cursor}")
    else:
        start = 0
    opt_state = adamw.init(params)  # moments restart (could be saved too)

    losses = []
    for step in range(start, steps):
        t0 = time.time()
        batch_np = data.next_batch()
        tbatch = {k: torch.from_numpy(v).to(model.device)
                  for k, v in batch_np.items()}
        loss, opt_state = step_fn(tbatch, opt_state)
        losses.append(float(loss))
        data.commit()
        monitor.heartbeat(0, step, time.time() - t0)
        monitor.sweep()
        if (step + 1) % ckpt_every == 0:
            store.save(step + 1, lm_arrays_from_params(params, cfg))
            if verbose:
                print(f"[train] step {step + 1} loss {float(loss):.4f} "
                      f"(checkpoint committed)")
        elif verbose and (step + 1) % 5 == 0:
            print(f"[train] step {step + 1} loss {float(loss):.4f}")
        if kill_at_step is not None and step + 1 == kill_at_step:
            if verbose:
                print(f"[train] injected power failure at step {step + 1}")
            pmem.crash(mode="powerfail")
            del model, params, opt_state, step_fn
            # restart: recursion re-enters through the restore path
            return train(arch, steps=steps, reduced=reduced, batch=batch,
                         seq_len=seq_len, ckpt_every=ckpt_every,
                         kill_at_step=None, seed=seed, pmem=pmem,
                         verbose=verbose, device=device)
    return {"losses": losses, "params": model.state_dict(), "store": store,
            "data": data, "final_step": steps, "remat": model.remat}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--kill-at-step", type=int, default=None)
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, ckpt_every=args.ckpt_every,
                kill_at_step=args.kill_at_step)
    print(f"[train] done: {out['final_step']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
