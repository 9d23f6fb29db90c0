"""The port's configs and dense-family model (repro_torch, device="cpu")
against the JAX package.

The JAX package's ``LM`` initialises Qwen2-0.5B's reduced configuration
from ``PRNGKey(0)``; ``convert.lm_params_from_arrays`` carries its
parameters into the port's ``LM``, and both run the same tokens (drawn
with numpy from a seed).  Tolerances:

* fp32-cast parameters: logits within 1e-4 (the same arithmetic, in
  another order, over two layers and a 512-word vocabulary);
* the bf16 parameters as ``dense_init`` makes them: logits within
  3e-2.  The logits are below 1 in magnitude, where one bf16 step is
  2^-8 to 2^-7; the two packages round activations to bf16 after each
  product at different points (JAX's decode casts the softmax weights
  to bf16 before P.V and forms the scores in bf16; the port's kernels
  keep both in fp32), so they may differ by a few steps.  The cached
  keys and values reach magnitude 4, where one bf16 step is 2^-6: they
  are held within 6.25e-2, four such steps (fp32: 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.configs import layer_kinds as jax_layer_kinds
from repro.models import common as jcommon
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import all_archs, get_arch, layer_kinds
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import LM, build_model
from repro_torch.models import common as tcommon

ARCH = "qwen2-0.5b"
TOL = {"fp32": 1e-4, "bf16": 3e-2}
CACHE_TOL = {"fp32": 1e-4, "bf16": 6.25e-2}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(jcfg, cfg, dtype, seed=0):
    """(JAX model, JAX params, port LM) on the same weights."""
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(to_np(jp), cfg),
                       assign=True)
    return jm, jp, lm


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def models(request):
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    return (request.param, cfg) + pair(jcfg, cfg, request.param)


def diff(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def test_prefill_and_decode_match_jax(models):
    """Prefill logits and caches, then four greedy decode steps over a
    cache padded to 48 slots (the JAX package's dense padding, rounded to
    whole 16-slot pages), against the JAX ``LM``."""
    dtype, cfg, jm, jp, lm = models
    rng = np.random.default_rng(1)
    T, S = 37, 48
    toks = rng.integers(0, cfg.vocab, size=(1, T))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, T)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, T)
    assert tl.shape == (1, cfg.vocab) and tl.dtype == lm.dtype
    assert diff(tl, jl) < TOL[dtype]
    for name in ("k", "v"):
        assert tc["blocks"]["l0"][name].shape == \
            jc["blocks"]["l0"][name].shape
        assert diff(tc["blocks"]["l0"][name], jc["blocks"]["l0"][name]) \
            < CACHE_TOL[dtype]
    jcache = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, S - T), (0, 0), (0, 0)]),
        jc)
    tcache = lm.init_caches(1, S)
    for name in ("k", "v"):
        tcache["blocks"]["l0"][name][:, :, :T] = tc["blocks"]["l0"][name]
    tok = int(np.argmax(np.asarray(jl[0], np.float32)))
    for pos in range(T, T + 4):
        jl, jcache = jm.decode_step(jp, jnp.asarray([tok], jnp.int32), jcache,
                                    jnp.asarray([pos], jnp.int32))
        tl, tcache = lm.decode_step(torch.tensor([tok]), tcache,
                                    torch.tensor([pos]))
        assert diff(tl, jl) < TOL[dtype], pos
        tok = int(np.argmax(np.asarray(jl[0], np.float32)))
    assert diff(tcache["blocks"]["l0"]["k"], jcache["blocks"]["l0"]["k"]) \
        < CACHE_TOL[dtype]


def test_batched_decode_matches_jax():
    """Two sequences at different positions in one decode step."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jm, jp, lm = pair(jcfg, cfg, "fp32", seed=3)
    rng = np.random.default_rng(4)
    S = 32
    jc = jm.init_caches(2, S, dtype=jnp.float32)
    fill = rng.normal(size=jc["blocks"]["l0"]["k"].shape).astype(np.float32)
    jc = {"blocks": {"l0": {"k": jnp.asarray(fill), "v": jnp.asarray(-fill)}}}
    tc = lm.init_caches(2, S)
    tc["blocks"]["l0"]["k"][:] = torch.from_numpy(fill)
    tc["blocks"]["l0"]["v"][:] = torch.from_numpy(-fill)
    tok, pos = np.array([5, 9]), np.array([3, 30])
    jl, _ = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                           jnp.asarray(pos, jnp.int32))
    tl, _ = lm.decode_step(torch.from_numpy(tok), tc, torch.from_numpy(pos))
    assert diff(tl, jl) < TOL["fp32"]


def test_one_layer_params_carry_across():
    """With one layer the JAX package does not stack the layer's leaves;
    the converter takes both forms."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=1)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), n_layers=1)
    jm, jp, lm = pair(jcfg, cfg, "fp32", seed=2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 11))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 11)
    tl, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 11)
    assert diff(tl, jl) < TOL["fp32"]


def test_state_dict_names_and_dtypes_are_the_jax_trees():
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jp = to_np(jax_build_model(jcfg).init_params(jax.random.PRNGKey(0)))
    sd = lm_params_from_arrays(jp, cfg)
    lm = LM(cfg, device="cpu")
    own = lm.state_dict()
    assert sorted(sd) == sorted(own)
    for name, t in own.items():
        assert sd[name].shape == t.shape, name
        assert sd[name].dtype == t.dtype, name
    assert own["layers.0.attn.wq"].dtype == torch.bfloat16
    assert own["layers.1.attn.bq"].dtype == torch.float32
    assert own["final_norm.w"].dtype == torch.float32
    assert torch.equal(sd["layers.1.ffn.w_gate"].float(), torch.from_numpy(
        np.asarray(jp["blocks"]["l0"]["ffn"]["w_gate"][1], np.float32)))


def test_init_is_seeded_and_sized():
    """Weights come from an explicit generator: the same seed gives the
    same model, another seed another one; the parameter count is the
    config's formula plus the final norm (which the formula leaves
    out), at reduced and at full width."""
    cfg = get_arch(ARCH).reduced()
    a, b, c = (LM(cfg, seed=s, device="cpu") for s in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.param_count() + cfg.d_model
    assert not any(p.requires_grad for p in a.parameters())
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (24, 896, 14, 2, 64,
                                                      4864, 151936)
    assert full.qkv_bias and full.tie_embeddings
    assert 490e6 < full.param_count() < 500e6


def test_configs_equal_the_jax_package():
    assert all_archs() == jax_all_archs()
    for name in all_archs():
        for cut in (False, True):
            c, j = get_arch(name), jax_get_arch(name)
            if cut:
                c, j = c.reduced(), j.reduced()
            assert dataclasses.asdict(c) == dataclasses.asdict(j), name
            assert layer_kinds(c) == jax_layer_kinds(j), name
            assert c.param_count() == j.param_count(), name
            assert c.active_param_count() == j.active_param_count(), name


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_encdec_and_vlm_build_reduced_and_prefill(arch):
    """Whisper (encoder-decoder) and InternVL (VLM) build at reduced()
    and prefill: Whisper's caches cover the text, InternVL's the patches
    and the text (tests/test_torch_whisper.py and tests/test_torch_vlm.py
    hold them to the JAX package)."""
    cfg = get_arch(arch).reduced()
    lm = build_model(cfg, device="cpu")
    batch = {"tokens": torch.arange(5)[None]}
    P = 0
    if cfg.encdec is not None:
        assert len(lm.encoder) == cfg.encdec.n_enc_layers
        batch["frames"] = torch.randn(1, cfg.encdec.n_audio_frames,
                                      cfg.d_model)
    if cfg.vision is not None:
        P = cfg.vision.n_patches
        assert lm.projector.shape == (cfg.vision.d_vit, cfg.d_model)
        batch["patches"] = torch.randn(1, P, cfg.vision.d_vit)
    logits, caches = lm.prefill(batch, 5)
    assert logits.shape == (1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert caches["blocks"]["l0"]["k"].shape == (
        cfg.n_layers, 1, P + 5, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "codeqwen1.5-7b",
                                  "minicpm-2b"])
def test_dense_archs_build_reduced(arch):
    cfg = get_arch(arch).reduced()
    lm = build_model(cfg, device="cpu")
    logits, caches = lm.prefill({"tokens": torch.arange(5)[None]}, 5)
    assert logits.shape == (1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert caches["blocks"]["l0"]["k"].shape == (
        cfg.n_layers, 1, 5, cfg.n_kv_heads, cfg.head_dim)


def test_rwkv_builds_reduced():
    """RWKV6 runs in the port (tests/test_torch_rwkv.py holds it to the
    JAX package): its prefill carries state, not a KV cache."""
    cfg = get_arch("rwkv6-7b").reduced()
    lm = build_model(cfg, device="cpu")
    logits, caches = lm.prefill({"tokens": torch.arange(5)[None]}, 5)
    assert logits.shape == (1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    H, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    assert caches["blocks"]["l0"]["wkv"].shape == (cfg.n_layers, 1, H, dh,
                                                   dh)
    assert set(caches["blocks"]["l0"]) == {"wkv", "shift_tm", "shift_cm"}


def test_hybrid_builds_reduced():
    """The hybrid runs in the port (tests/test_torch_hybrid.py holds it
    to the JAX package): one superblock of 8 sublayers, its prefill
    carrying Mamba state at 7 positions and a KV cache at the 5th."""
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    lm = build_model(cfg, device="cpu")
    logits, caches = lm.prefill({"tokens": torch.arange(5)[None]}, 5)
    assert logits.shape == (1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    group = caches["blocks"]
    assert sorted(group) == [f"l{i}" for i in range(8)]
    assert group["l4"]["k"].shape == (1, 5, cfg.n_kv_heads, cfg.head_dim)
    assert all(set(group[f"l{i}"]) == {"ssm", "conv"}
               for i in (0, 1, 2, 3, 5, 6, 7))


def test_lm_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_arch(ARCH).reduced())


def test_common_blocks_match_jax():
    """Norms in fp32 cast back, the interleaved RoPE (not rotate-half),
    and the causal mask, on the same inputs."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    pos = np.arange(7)[None] + 100
    for dt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                         (jnp.bfloat16, torch.bfloat16, 1e-2)):
        jx, tx = jnp.asarray(x, dt), torch.from_numpy(x).to(tdt)
        assert diff(tcommon.rmsnorm(tx, torch.from_numpy(w), 1e-5),
                    jcommon.rmsnorm(jx, jnp.asarray(w), 1e-5)) < tol
        assert diff(tcommon.layernorm(tx, torch.from_numpy(w),
                                      torch.from_numpy(b), 1e-5),
                    jcommon.layernorm(jx, jnp.asarray(w), jnp.asarray(b),
                                      1e-5)) < tol
        got = tcommon.apply_rope(tx, torch.from_numpy(pos), 1e6)
        assert got.dtype == tdt
        assert diff(got, jcommon.apply_rope(jx, jnp.asarray(pos), 1e6)) < tol
    for window in (None, 3):
        assert np.array_equal(
            tcommon.causal_mask(5, 9, window=window, q_offset=4).numpy(),
            np.asarray(jcommon.causal_mask(5, 9, window=window, q_offset=4)))
