"""Serving driver: batched requests through the paged engine, with a
crash/restart demonstration of the persistent prefix cache.  The port
of ``repro.launch.serve``.

The JAX driver always serves the reduced configuration on the CPU; the
port serves the named architecture (a dense or MoE config, or
``rwkv6-7b``; Whisper and InternVL are refused before any weight is
drawn, ``check_serves``) at full width on the card by default, with weights drawn
at random from ``seed`` (no checkpoint exists to load).  A
configuration whose bf16 weights do not fit one card serves only with
``reduced=True``: ``mixtral-8x22b`` (281 GB) and the hybrid
``jamba-1.5-large-398b``, whose least depth, one superblock, already
holds 90 GB.  ``reduced=True, device="cpu"`` gives the setting of
``repro.launch.serve``.  Run ``python -m repro_torch.launch.serve`` with
``PYTHONPATH=src``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs.base import get_arch
from ..models.model import build_model
from ..serving.engine import Server, check_serves

CARD_BYTES = 80e9  # device memory of the one H100 the port targets


def check_fits(cfg) -> None:
    """Raise for a configuration whose least servable depth does not
    fit one card in bf16.  For the hybrid that depth is one superblock
    (``attn_every`` layers, the unit ``group_plan`` repeats):
    Jamba-1.5-Large's holds 45.1 B parameters, 90 GB.  For every other
    family it is the whole model: Mixtral-8x22B holds 140.6 B
    parameters, 281 GB."""
    if cfg.family == "hybrid":
        least = dataclasses.replace(cfg, n_layers=cfg.attn_every)
        what = (f"one superblock of {cfg.attn_every} layers, the least "
                "depth its layer grouping takes, holds")
    else:
        least, what = cfg, f"its {cfg.n_layers} layers hold"
    need = 2 * least.param_count()
    if need > CARD_BYTES:
        raise NotImplementedError(
            f"{cfg.name} at full width does not fit one card: {what} "
            f"{least.param_count():,} parameters, {need / 1e9:.1f} GB "
            f"in bf16, against the card's {CARD_BYTES / 1e9:.0f} GB; serve "
            "it with reduced=True")


def serve(arch: str = "qwen2-0.5b", *, device=None, reduced: bool = False,
          n_requests: int = 6, prompt_len: int = 32, max_new: int = 8,
          crash_midway: bool = False, seed: int = 0, verbose: bool = True):
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    check_serves(cfg)
    check_fits(cfg)
    model = build_model(cfg, seed=seed, device=device)
    server = Server(model, page_size=16, n_pages=256)
    rng = np.random.default_rng(seed)
    shared_prefix = [int(t) for t in rng.integers(1, cfg.vocab, 16)]
    for i in range(n_requests):
        tail = [int(t) for t in rng.integers(1, cfg.vocab,
                                             prompt_len - 16)]
        server.submit(shared_prefix + tail, max_new=max_new)
        if crash_midway and i == n_requests // 2:
            server.run_until_drained(max_len=prompt_len + max_new + 2)
            before = dict(server.stats)
            if verbose:
                print(f"[serve] crashing the node after "
                      f"{before['decode_steps']} decode steps")
            server.crash_and_recover()
            if verbose:
                print("[serve] recovered: block table and prefix cache "
                      "restored with no repair pass")
    server.run_until_drained(max_len=prompt_len + max_new + 2)
    if verbose:
        print(f"[serve] stats: {server.stats}")
    return server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--crash-midway", action="store_true")
    args = ap.parse_args()
    serve(args.arch, n_requests=args.requests,
          crash_midway=args.crash_midway)


if __name__ == "__main__":
    main()
