"""Whisper (encoder-decoder) in the port (repro_torch, ``device="cpu"``)
against the JAX package's ``LM``, at ``reduced()``: 2 encoder layers over
32 frames, 2 decoder layers of self-attention, cross attention and a
GELU MLP, d_model 128, 4 heads of 32, LayerNorm.

The JAX package initialises the configuration from ``PRNGKey(0)``, cast
to fp32; ``convert.lm_params_from_arrays`` carries its parameters into
the port's ``LM`` (the encoder stacked on axis 0), and both run the
same frames and tokens, drawn with numpy from a seed.  On the CPU the
port runs its kernels' plain versions.  Tolerances, the same fp32
arithmetic in another order: the encoder's output, the cross
attention's and the logits within 1e-5 of their largest magnitude; the
prefill's caches within 1e-5 of their largest; 8 teacher-forced decode
steps within 1e-4 of the largest logit (the paged kernel's plain version
and the JAX decode's softmax sum in other orders).  The loss and its
gradients are held to ``jax.value_and_grad`` in
``tests/test_torch_train.py::test_loss_and_grads_match_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.steps import make_decode_step, make_train_step
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.optim import adamw

ARCH = "whisper-tiny"
TOL = 1e-5
DECODE_TOL = 1e-4
B, T = 2, 12


def rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max()) / max(
        float(np.abs(j).max()), 1e-30)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX fp32 params, port LM on the same weights, config,
    a batch of frames and tokens as numpy arrays)."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    assert cfg.encdec.n_enc_layers == 2 and cfg.encdec.n_audio_frames == 32
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "frames": rng.normal(size=(B, cfg.encdec.n_audio_frames,
                                        cfg.d_model)).astype(np.float32)}
    return jm, jp, lm, cfg, batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_layers_follow_the_plan(pair):
    """``layer_kinds`` says ("attn", "mlp"); the decoder's layers are the
    plan's ("cross", "mlp"), each with ``ln3`` and ``cross``."""
    _, jp, lm, cfg, _ = pair
    assert [blk.kind for blk in lm.layers] == [("cross", "mlp")] * 2
    assert all(hasattr(blk, "ln3") and hasattr(blk, "cross")
               for blk in lm.layers)
    assert [blk.kind for blk in lm.encoder] == [("attn", "mlp")] * 2
    assert sorted(jp["encoder"]) == ["attn", "ffn", "ln1", "ln2"]


def test_encode_matches_jax(pair):
    jm, jp, lm, cfg, batch = pair
    want = jm._encode(jp, jnp.asarray(batch["frames"]))
    got = lm._encode(torch.from_numpy(batch["frames"]))
    assert got.shape == (B, cfg.encdec.n_audio_frames, cfg.d_model)
    assert rel(got, want) <= TOL


def test_cross_attn_forward_matches_jax(pair):
    """T = 5 decoder positions against S = 32 encoder rows."""
    jm, jp, lm, cfg, batch = pair
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, cfg.encdec.n_audio_frames,
                           cfg.d_model)).astype(np.float32)
    jcross = jax.tree.map(lambda a: a[1], jp["blocks"]["l0"]["cross"])
    want = jattn.cross_attn_forward(jcross, jnp.asarray(x), jnp.asarray(enc),
                                    cfg)
    got = tattn.cross_attn_forward(lm.layers[1].cross, torch.from_numpy(x),
                                   torch.from_numpy(enc), cfg)
    assert got.shape == (B, 5, cfg.d_model)
    assert rel(got, want) <= TOL


def test_forward_matches_jax(pair):
    jm, jp, lm, cfg, batch = pair
    want, _ = jax.jit(jm.forward)(jp, jax_batch(batch))
    got, aux = lm.forward(torch_batch(batch))
    assert got.shape == (B, T, cfg.vocab) and aux.item() == 0.0
    assert rel(got, want) <= TOL


def test_prefill_matches_jax(pair):
    """The last position's logits, and each layer's self-attention k and
    v (the encoder's output is not cached, as in the JAX package)."""
    jm, jp, lm, cfg, batch = pair
    want, jcaches = jm.prefill(jp, jax_batch(batch), T)
    got, caches = lm.prefill(torch_batch(batch), T)
    assert got.shape == (B, cfg.vocab)
    assert rel(got, want) <= TOL
    assert sorted(caches) == sorted(jcaches) == ["blocks"]
    for name in ("k", "v"):
        t, j = caches["blocks"]["l0"][name], jcaches["blocks"]["l0"][name]
        assert tuple(t.shape) == j.shape == (
            cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
        assert rel(t, j) <= TOL, name


def test_decode_steps_match_jax(pair):
    """8 teacher-forced ``decode_step(..., enc=)`` steps from empty caches
    of 16 slots (one page), against the JAX decode with the JAX
    encoder's output."""
    jm, jp, lm, cfg, batch = pair
    jenc = jm._encode(jp, jnp.asarray(batch["frames"]))
    enc = lm._encode(torch.from_numpy(batch["frames"]))
    jcaches = jm.init_caches(B, 16, dtype=jnp.float32)
    caches = lm.init_caches(B, 16)
    jstep = jax.jit(lambda p, tk, c, ps, e: jm.decode_step(p, tk, c, ps,
                                                            enc=e))
    toks = batch["tokens"]
    for t in range(8):
        want, jcaches = jstep(jp, jnp.asarray(toks[:, t]), jcaches,
                              jnp.full((B,), t, jnp.int32), jenc)
        got, caches = lm.decode_step(torch.from_numpy(toks[:, t]).long(),
                                     caches, torch.full((B,), t), enc=enc)
        assert rel(got, want) <= DECODE_TOL, t


def test_decode_step_needs_the_encoders_output(pair):
    _, _, lm, cfg, _ = pair
    with pytest.raises(ValueError, match="encoder's output"):
        lm.decode_step(torch.zeros(1, dtype=torch.int64),
                       lm.init_caches(1, 16), torch.zeros(1))


def test_make_decode_step_with_enc_and_a_train_step():
    """``make_decode_step(with_enc=True)`` passes the encoder's output
    through; a ``make_train_step`` step on a batch with frames moves
    every parameter the loss reaches, the encoder's included."""
    cfg = get_arch(ARCH).reduced()
    lm = LM(cfg, device="cpu", seed=2).float()
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.normal(size=(1, 32, cfg.d_model))
                              .astype(np.float32))
    enc = lm._encode(frames)
    caches = lm.init_caches(1, 16)
    tok = torch.tensor([7])
    step = make_decode_step(lm, with_enc=True)
    got, _ = step(tok, caches, torch.zeros(1, dtype=torch.int64), enc)
    want, _ = lm.decode_step(tok, lm.init_caches(1, 16),
                             torch.zeros(1, dtype=torch.int64), enc=enc)
    assert torch.equal(got, want)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.from_numpy(rng.normal(size=(
                 2, 32, cfg.d_model)).astype(np.float32))}
    before = {k: p.detach().clone() for k, p in lm.named_parameters()}
    train_step = make_train_step(lm, cfg.name)
    state = adamw.init(dict(lm.named_parameters()))
    want_loss = lm.loss(batch).item()
    loss, state = train_step(batch, state)
    assert state.step == 1 and loss.item() == pytest.approx(want_loss)
    moved = {k for k, p in lm.named_parameters()
             if not torch.equal(p.detach(), before[k])}
    assert "encoder.0.attn.wq" in moved and "layers.1.cross.wk" in moved
    assert "projector" not in before and "enc_norm.w" in moved
