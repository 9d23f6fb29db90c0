"""InternVL (VLM) in the port (repro_torch, ``device="cpu"``) against the
JAX package's ``LM``, at ``reduced()``: 16 precomputed patch embeddings
of width 64 projected into d_model 128 and put before the text, 2
decoder layers, 4 query heads over one kv head (GQA), RMSNorm, SwiGLU.

The JAX package initialises the configuration from ``PRNGKey(0)``, cast
to fp32; ``convert.lm_params_from_arrays`` carries its parameters into
the port's ``LM`` (``projector`` by name), and both run the same
patches and tokens, drawn with numpy from a seed.  On the CPU the port
runs its kernels' plain versions.  Tolerances, the same fp32 arithmetic
in another order: the decoder's input and the logits (over the text
positions only) within 1e-5 of their largest magnitude; the prefill's
caches (over the patches' positions and the text's) within 1e-5 of
their largest; 4 decode steps after the prefill within 1e-4 of the
largest logit.  The JAX package's own decode test leaves the VLM out
(``tests/test_models_smoke.py``); here both packages decode it after
their prefill.  The loss and its gradients are held to
``jax.value_and_grad`` in
``tests/test_torch_train.py::test_loss_and_grads_match_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import LM
from repro_torch.optim import adamw

ARCH = "internvl2-76b"
TOL = 1e-5
DECODE_TOL = 1e-4
B, T = 2, 10
SLOTS = 32  # the caches padded to two 16-slot pages for 4 decode steps


def rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max()) / max(
        float(np.abs(j).max()), 1e-30)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX fp32 params, port LM on the same weights, config,
    a batch of patches and tokens as numpy arrays)."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    assert (cfg.vision.n_patches, cfg.vision.d_vit) == (16, 64)
    assert cfg.n_kv_heads == 1 < cfg.n_heads
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "patches": rng.normal(size=(B, cfg.vision.n_patches,
                                         cfg.vision.d_vit)).astype(np.float32)}
    return jm, jp, lm, cfg, batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_projected_patches_lead_the_text(pair):
    """``_embed_inputs``: [B, P + T, D], the projected patches first; no
    encoder output."""
    jm, jp, lm, cfg, batch = pair
    want, jenc = jm._embed_inputs(jp, jax_batch(batch))
    got, enc = lm._embed_inputs(torch_batch(batch))
    assert enc is None and jenc is None
    assert got.shape == (B, cfg.vision.n_patches + T, cfg.d_model)
    assert rel(got, want) <= TOL
    assert torch.equal(got[:, cfg.vision.n_patches:],
                       lm.embed[torch.from_numpy(batch["tokens"]).long()])


def test_forward_matches_jax_on_the_text_positions(pair):
    jm, jp, lm, cfg, batch = pair
    want, _ = jax.jit(jm.forward)(jp, jax_batch(batch))
    got, aux = lm.forward(torch_batch(batch))
    assert got.shape == want.shape == (B, T, cfg.vocab)
    assert aux.item() == 0.0
    assert rel(got, want) <= TOL


def test_prefill_matches_jax(pair):
    """The last position's logits, and each layer's k and v over the
    patches' positions and the text's."""
    jm, jp, lm, cfg, batch = pair
    P = cfg.vision.n_patches
    want, jcaches = jm.prefill(jp, jax_batch(batch), P + T)
    got, caches = make_prefill_step(lm, P + T)(torch_batch(batch))
    assert got.shape == (B, cfg.vocab)
    assert rel(got, want) <= TOL
    for name in ("k", "v"):
        t, j = caches["blocks"]["l0"][name], jcaches["blocks"]["l0"][name]
        assert tuple(t.shape) == j.shape == (
            cfg.n_layers, B, P + T, cfg.n_kv_heads, cfg.head_dim)
        assert rel(t, j) <= TOL, name


def test_decode_after_prefill_matches_jax(pair):
    """Both prefills' caches padded to ``SLOTS``, then 4 steps from
    position P + T, each side feeding the tokens of the JAX logits'
    argmax, through ``make_decode_step``."""
    jm, jp, lm, cfg, batch = pair
    P = cfg.vision.n_patches
    jlogits, jcaches = jm.prefill(jp, jax_batch(batch), P + T)
    logits, caches = lm.prefill(torch_batch(batch), P + T)

    def jpad(c):
        return jnp.pad(c, [(0, 0)] * (c.ndim - 3) + [(0, SLOTS - P - T),
                                                      (0, 0), (0, 0)])

    def tpad(c):
        out = c.new_zeros(c.shape[:-3] + (SLOTS,) + c.shape[-2:])
        out[..., :P + T, :, :] = c
        return out

    jcaches = jax.tree.map(jpad, jcaches)
    caches = {"blocks": {"l0": {k: tpad(v) for k, v in
                                caches["blocks"]["l0"].items()}}}
    jstep = jax.jit(jm.decode_step)
    step = make_decode_step(lm)
    tok = np.argmax(np.asarray(jlogits), axis=-1)
    for i in range(4):
        pos = P + T + i
        want, jcaches = jstep(jp, jnp.asarray(tok, jnp.int32), jcaches,
                              jnp.full((B,), pos, jnp.int32))
        got, caches = step(torch.from_numpy(tok).long(), caches,
                           torch.full((B,), pos))
        assert rel(got, want) <= DECODE_TOL, i
        tok = np.argmax(np.asarray(want), axis=-1)


def test_a_train_step_on_a_batch_with_patches():
    """A ``make_train_step`` step on patches and tokens moves the
    projector and every layer's weights; the loss is over the text."""
    cfg = get_arch(ARCH).reduced()
    lm = LM(cfg, device="cpu", seed=2).float()
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": torch.from_numpy(rng.normal(size=(
                 2, cfg.vision.n_patches, cfg.vision.d_vit))
                 .astype(np.float32))}
    before = {k: p.detach().clone() for k, p in lm.named_parameters()}
    train_step = make_train_step(lm, cfg.name)
    state = adamw.init(dict(lm.named_parameters()))
    want_loss = lm.loss(batch).item()
    loss, state = train_step(batch, state)
    assert state.step == 1 and loss.item() == pytest.approx(want_loss)
    moved = {k for k, p in lm.named_parameters()
             if not torch.equal(p.detach(), before[k])}
    assert {"projector", "layers.0.attn.wq", "layers.1.ffn.w_down",
            "lm_head"} <= moved, sorted(set(before) - moved)
