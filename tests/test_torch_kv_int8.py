"""The int8 KV cache (the ``kv_int8`` variant) against the JAX package on
the CPU.

The JAX package quantizes a new key and value as ``clip(round(x * 32),
-127, 127)`` in fp32 and dequantizes the whole cache to bf16 (``k *
(1/32)``) before its attention; the port quantizes the same way
(``attention.quantize_kv``) and its paged kernel reads the int8 pages
times 1/32 (``paged_attention_plain`` on the CPU).  Tolerances:

* the quantized cache: bit-identical (the same fp32 products, rounded
  half to even by ``torch.round`` and ``jnp.round``);
* ``paged_attention_plain`` on int8 pages against the JAX package's
  ``paged_attention_ref`` on the dequantized pages in fp32: 1e-5 (the
  same fp32 arithmetic in another order; int8 / 32 is exact in bf16 and
  fp32);
* ``LM.decode_step`` with an int8 cache at Qwen2-0.5B ``reduced()``,
  fp32 weights, 4 steps: layer 0's cache bit-identical after every step
  (its keys and values depend on the tokens alone); the logits within
  1e-4 plus 2^-7 of the largest logit of JAX's.  The cause of the second
  term: on an int8 cache the JAX decode dequantizes to bf16, so its
  softmax weights are cast to bf16 (``w.astype(v.dtype)``) and its P.V
  product is a bf16 result even with fp32 activations, two roundings of
  2^-9 each of every layer's attention output; the port keeps both in
  fp32 (so does the JAX package's own fp32 cache, where the two agree
  within 1e-4: ``test_torch_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.analysis import roofline
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.models import LM
from repro_torch.models import attention as tattn

ARCH = "qwen2-0.5b"
PLAIN_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_STEPS = 2.0 ** -7  # of the largest logit: JAX's bf16 P and P.V


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(seed=0):
    """(JAX model, its fp32 params, the port LM on the same weights)."""
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(seed)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(to_np(jp), cfg), assign=True)
    return cfg, jm, jp, lm


def test_kv_qscale_is_the_jax_packages():
    assert tattn.KV_QSCALE == jattn.KV_QSCALE == 32.0


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5 / 32, 1.5 / 32, 2.5 / 32, -0.5 / 32, 5.0, -5.0,
                      3.96875, -3.984375])
    want = np.clip(np.round(np.asarray(x) * 32), -127, 127)
    assert tattn.quantize_kv(x).tolist() == want.astype(np.int8).tolist()
    assert tattn.quantize_kv(x).tolist()[:4] == [0, 2, 2, 0]


def test_attn_decode_cache_is_bit_identical_to_jax():
    """One layer's decode on the same fp32 inputs and int8 cache: the
    new slots equal JAX's bit for bit; every other slot is untouched."""
    cfg, jm, jp, lm = pair()
    rng = np.random.default_rng(7)
    B, S = 3, 48
    Hk, dh = cfg.n_kv_heads, cfg.head_dim
    lp = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32) * 4
    k0 = rng.integers(-127, 128, size=(B, S, Hk, dh)).astype(np.int8)
    v0 = rng.integers(-127, 128, size=(B, S, Hk, dh)).astype(np.int8)
    pos = np.array([0, 17, S - 1])
    _, jc = jattn.attn_decode(lp, jnp.asarray(x),
                              {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                              jax_get_arch(ARCH).reduced(),
                              pos=jnp.asarray(pos))
    tp = {k: torch.from_numpy(np.array(a)) for k, a in lp.items()}
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    tattn.attn_decode(tp, torch.from_numpy(x), cache, cfg,
                      pos=torch.from_numpy(pos))
    for name in ("k", "v"):
        got, want = cache[name].numpy(), np.asarray(jc[name])
        assert got.dtype == want.dtype == np.int8
        assert np.array_equal(got, want), name
        # the slots written hold new values, not the old ones
        assert not np.array_equal(got[np.arange(B), pos],
                                  (k0 if name == "k" else v0)[np.arange(B),
                                                              pos])


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_paged_plain_int8_matches_jax_dequantized(q_dtype, window):
    """``paged_attention_plain`` on int8 pages (GQA, pages out of order,
    lengths 1, 15, 16, 17, 40) against JAX's reference on the pages
    dequantized and the kv heads repeated, fp32 (and a bf16 q against the
    same q rounded); with a window, against the reference over the
    window's keys alone."""
    rng = np.random.default_rng(11)
    B, H, Hk, dh, PS, MAXP = 5, 8, 2, 32, 16, 3
    NP = B * MAXP
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    tq = torch.from_numpy(q).to(q_dtype)
    q = tq.float().numpy()
    pk = rng.integers(-127, 128, size=(NP, PS, Hk, dh)).astype(np.int8)
    pv = rng.integers(-127, 128, size=(NP, PS, Hk, dh)).astype(np.int8)
    table = rng.permutation(NP).astype(np.int32).reshape(B, MAXP)
    lens = np.array([1, 15, 16, 17, 40], np.int32)
    got = kpaged.paged_attention_plain(
        tq, torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(lens), window,
        kv_scale=1 / 32).float().numpy()
    deq = lambda p: np.repeat(  # noqa: E731
        np.asarray(jnp.asarray(p).astype(jnp.bfloat16) * (1 / 32),
                   np.float32), H // Hk, axis=2)
    for b in range(B):
        n = int(lens[b])
        lo = 0 if window is None else max(0, n - window)
        # the live keys as a table of their own, from the window's start
        keys = np.arange(lo, n)
        k = deq(pk)[table[b, keys // PS], keys % PS][None, :, None]
        v = deq(pv)[table[b, keys // PS], keys % PS][None, :, None]
        want = paged_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[0]), jnp.asarray(v[0]),
            jnp.arange(len(keys), dtype=jnp.int32)[None],
            jnp.asarray([len(keys)], jnp.int32))
        err = np.abs(got[b] - np.asarray(want[0], np.float32)).max()
        tol = PLAIN_TOL if q_dtype == torch.float32 else 2e-2
        assert err < tol, (b, err)


def test_paged_wrapper_refuses_mixed_forms():
    q = torch.zeros(1, 2, 32)
    pages = torch.zeros(2, 16, 1, 32, dtype=torch.int8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_scale"):
        kpaged.paged_attention(q, pages, pages, table, lens)
    with pytest.raises(ValueError, match="kv_scale"):
        kpaged.paged_attention(q, pages.float(), pages.float(), table, lens,
                               kv_scale=1 / 32)
    with pytest.raises(TypeError):
        kpaged.paged_attention(q, pages.bfloat16(), pages.bfloat16(), table,
                               lens)


def test_paged_wrapper_on_meta_charges_every_page():
    """A ``meta`` call launches nothing and charges the int8 form's work
    over every page of the table (a meta length has no value)."""
    B, H, Hk, dh, PS, MAXP = 4, 14, 2, 64, 16, 8
    meta = torch.device("meta")
    q = torch.empty(B, H, dh, dtype=torch.bfloat16, device=meta)
    pages = torch.empty(B * MAXP, PS, Hk, dh, dtype=torch.int8, device=meta)
    table = torch.empty(B, MAXP, dtype=torch.int32, device=meta)
    lens = torch.empty(B, dtype=torch.int32, device=meta)
    before = dict(kpaged.LAUNCHES)
    costs, out = roofline.count_costs(
        kpaged.paged_attention, q, pages, pages, table, lens,
        kv_scale=1 / 32)
    assert out.shape == q.shape and out.device == meta
    assert kpaged.LAUNCHES == before
    want = roofline.paged_work([MAXP * PS] * B, H, Hk, dh, PS, 2, 1)
    got = costs.kernels["paged_attention int8"]
    assert got["calls"] == 1
    assert got["bytes"] == want.bytes and got["flops"] == want.flops
    # int8 pages move half the bf16 pages' key and value bytes
    bf16 = roofline.paged_work([MAXP * PS] * B, H, Hk, dh, PS)
    kv = 2 * B * MAXP * PS * Hk * dh
    assert bf16.bytes - want.bytes == kv


def test_lm_decode_int8_matches_jax():
    """Qwen2-0.5B ``reduced()``, fp32 weights, an int8 cache from
    ``init_caches`` filled at random: 4 decode steps of 2 sequences at
    different positions against the JAX decode with ``cache_dtype =
    int8`` (see the module docstring for the tolerance)."""
    cfg, jm, jp, lm = pair()
    jm.cache_dtype = jnp.int8
    lm.cache_dtype = torch.int8
    rng = np.random.default_rng(1)
    B, S = 2, 48
    jc = jm.init_caches(B, S)
    tc = lm.init_caches(B, S)
    assert tc["blocks"]["l0"]["k"].dtype == torch.int8
    shape = jc["blocks"]["l0"]["k"].shape
    assert tuple(tc["blocks"]["l0"]["k"].shape) == shape
    fill = rng.integers(-127, 128, size=shape).astype(np.int8)
    jc = {"blocks": {"l0": {"k": jnp.asarray(fill), "v": jnp.asarray(-fill)}}}
    tc["blocks"]["l0"]["k"][:] = torch.from_numpy(fill)
    tc["blocks"]["l0"]["v"][:] = torch.from_numpy(-fill)
    tok, pos = np.array([5, 9]), np.array([20, 40])
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = lm.decode_step(torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        jl = np.asarray(jl, np.float32)
        err = float(np.abs(tl.numpy() - jl).max())
        assert err < LOGIT_TOL + BF16_STEPS * float(np.abs(jl).max()), err
        for name in ("k", "v"):  # layer 0: the tokens' keys alone
            assert np.array_equal(tc["blocks"]["l0"][name][0].numpy(),
                                  np.asarray(jc["blocks"]["l0"][name][0]))
        tok, pos = jl.argmax(-1), pos + 1


def test_r9_recurrent_state_keeps_the_activations_dtype():
    """Reference fault R9: the JAX package's ``init_caches`` hands the
    cache dtype to RWKV6's token shifts and Mamba's conv tail, so
    ``kv_int8`` truncates those activations to int8 (its decode stores
    ``xt.astype(int8)``, a cast with no scale).  The port quantizes
    attention k and v only."""
    for arch, names in (("rwkv6-7b", ("shift_tm", "shift_cm")),
                        ("jamba-1.5-large-398b", ("conv",))):
        jm = jax_build_model(jax_get_arch(arch).reduced())
        jm.cache_dtype = jnp.int8
        jc = jax.eval_shape(lambda: jm.init_caches(2, 32))
        lm = LM(get_arch(arch).reduced(), device="meta")
        lm.cache_dtype = torch.int8
        tc = lm.init_caches(2, 32)
        for leaves, tleaves in zip(jc["blocks"].values(),
                                   tc["blocks"].values()):
            for name in names:
                if name not in leaves:
                    continue
                assert leaves[name].dtype == jnp.int8
                assert tleaves[name].dtype == lm.dtype == torch.bfloat16
            if "k" in leaves:
                assert tleaves["k"].dtype == torch.int8


def test_cache_dtype_defaults_to_the_activations():
    cfg = get_arch(ARCH).reduced()
    lm = LM(cfg, device="meta")
    assert lm.cache_dtype == lm.dtype == torch.bfloat16
    lm.cache_dtype = torch.int8
    assert lm.init_caches(1, 16)["blocks"]["l0"]["v"].dtype == torch.int8
    lm.cache_dtype = None
    assert lm.float().cache_dtype == torch.float32
    one = LM(dataclasses.replace(cfg, n_layers=1), device="meta")
    assert one.init_caches(1, 16)["blocks"]["l0"]["k"].dtype == torch.bfloat16
