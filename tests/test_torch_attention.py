"""The port's attention kernels' plain versions and ops (repro_torch,
CPU tensors) against the JAX package's Pallas kernels in interpret
mode, their jnp oracles and the model's attention layer.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: float32 outputs agree within 1e-5 (the same arithmetic in
another order).  In bfloat16 the port and the Pallas kernels keep the
softmax weights in fp32 for the P.V product, while ``attention_ref``
casts them to bf16 first; 2e-2 is the JAX package's own tolerance for
its kernel against that oracle (``tests/test_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref
from repro.kernels.paged_attention import paged_mqa as jax_paged_mqa
from repro.models import attention as jattn
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.models import attention as tattn

TOL = {"fp32": 1e-5, "bf16": 2e-2}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def draw(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def both(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a, JNP[dtype]),
            torch.from_numpy(a).to(TORCH[dtype]))


def err(t, j):
    return float(np.abs(t.float().numpy()
                        - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("BH,T,S,dh,causal,window,qb,kb", [
    (4, 256, 256, 64, True, None, 128, 128),
    (2, 128, 256, 64, True, None, 64, 64),  # right-aligned queries
    (2, 256, 256, 128, False, None, 128, 64),
    (2, 256, 256, 64, True, 96, 64, 64),  # sliding window
    (1, 512, 512, 64, True, None, 128, 256),
])
def test_flash_attention_matches_pallas_and_ref(BH, T, S, dh, causal, window,
                                                qb, kb, dtype):
    """tests/test_kernels.py's shapes: the port's [B, T, H, dh] op on
    [BH, T, 1, dh] against the Pallas kernel on [BH, T, dh]."""
    rng = np.random.default_rng(BH * T + S + dh)
    (jq, tq), (jk, tk), (jv, tv) = (both(draw(rng, (BH, n, dh)), dtype)
                                    for n in (T, S, S))
    got = kflash.mha(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                     causal=causal, window=window)[:, :, 0]
    assert got.dtype == TORCH[dtype] and got.shape == (BH, T, dh)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       q_block=qb, kv_block=kb)
    ref = attention_ref(jq[:, None], jk[:, None], jv[:, None],
                        causal=causal, window=window)[:, 0]
    assert err(got, pallas) < TOL[dtype]
    assert err(got, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,Hk,dh,window", [
    (2, 128, 128, 8, 2, 64, None),   # the JAX GQA wrapper test's shape
    (2, 37, 37, 4, 2, 32, None),     # ragged T, reduced Qwen2 widths
    (1, 37, 37, 14, 2, 64, None),    # ragged T, full Qwen2 heads
    (2, 37, 61, 4, 1, 32, 9),        # ragged, right-aligned, windowed
])
def test_mha_gqa_matches_jax(B, T, S, H, Hk, dh, window, dtype):
    """GQA by indexing kv head h // (H // Hk) equals the JAX wrapper's
    ``jnp.repeat`` of the kv heads, and ``attention_ref``."""
    rng = np.random.default_rng(T * H + S)
    (jq, tq) = both(draw(rng, (B, T, H, dh)), dtype)
    (jk, tk), (jv, tv) = (both(draw(rng, (B, S, Hk, dh)), dtype)
                          for _ in range(2))
    got = kflash.mha(tq, tk, tv, window=window)
    assert got.shape == (B, T, H, dh)
    jax_out = jax_mha(jq, jk, jv, window=window, q_block=T, kv_block=S)
    assert err(got, jax_out) < TOL[dtype]
    kr = jnp.repeat(jk, H // Hk, axis=2).transpose(0, 2, 1, 3)
    vr = jnp.repeat(jv, H // Hk, axis=2).transpose(0, 2, 1, 3)
    ref = attention_ref(jq.transpose(0, 2, 1, 3), kr, vr, causal=True,
                        window=window).transpose(0, 2, 1, 3)
    assert err(got, ref) < TOL[dtype]


def test_flash_rows_without_keys_are_zero():
    """T > S: right-aligned rows before the first key see nothing and
    are 0 (the jnp oracle gives NaN there); the rest match it."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(draw(rng, (1, n, 2, 32))) for n in (9, 5, 5))
    out = kflash.attention_plain(q, k, v)
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))
    ref = attention_ref(jnp.asarray(q.numpy()).transpose(0, 2, 1, 3),
                        jnp.asarray(k.numpy()).transpose(0, 2, 1, 3),
                        jnp.asarray(v.numpy()).transpose(0, 2, 1, 3))
    assert err(out[:, 4:], ref.transpose(0, 2, 1, 3)[:, 4:]) < 1e-5


def paged_inputs(rng, B, H, Hk, dh, NP, PS, MAXP):
    q = draw(rng, (B, H, dh))
    pk, pv = draw(rng, (NP, PS, Hk, dh)), draw(rng, (NP, PS, Hk, dh))
    table = (rng.permutation(NP)[:B * MAXP].reshape(B, MAXP)
             if NP >= B * MAXP else rng.integers(0, NP, size=(B, MAXP)))
    lens = rng.integers(1, PS * MAXP, size=(B,))
    return q, pk, pv, table.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("B,H,dh,NP,PS,MAXP", [
    (3, 4, 64, 16, 32, 4), (2, 2, 128, 8, 16, 4), (4, 8, 64, 32, 64, 8),
])
def test_paged_attention_matches_pallas_and_ref(B, H, dh, NP, PS, MAXP):
    """tests/test_kernels.py's shapes (one kv head per query head)."""
    rng = np.random.default_rng(B * H * dh)
    arrays = paged_inputs(rng, B, H, H, dh, NP, PS, MAXP)
    got = kpaged.paged_attention(*map(torch.from_numpy, arrays))
    j = [jnp.asarray(a) for a in arrays]
    assert err(got, jax_paged(*j)) < 1e-5
    assert err(got, paged_attention_ref(*j)) < 1e-5


@pytest.mark.parametrize("B,H,Hk,dh,NP,PS,MAXP", [
    (1, 14, 2, 64, 40, 16, 34),   # Qwen2-0.5B's heads, 544 slots
    (3, 4, 2, 32, 16, 16, 4),     # reduced widths
    (2, 8, 1, 64, 12, 32, 6),
])
def test_paged_mqa_gqa_matches_jax(B, H, Hk, dh, NP, PS, MAXP):
    """GQA inside the kernel equals the JAX wrapper's repeat of every
    page's kv heads; a table entry of -1 reads page 0 in both."""
    rng = np.random.default_rng(H * Hk + MAXP)
    q, pk, pv, table, lens = paged_inputs(rng, B, H, Hk, dh, NP, PS, MAXP)
    table[-1, -1] = -1
    arrays = (q, pk, pv, table, lens)
    got = kpaged.paged_mqa(*map(torch.from_numpy, arrays))
    assert got.shape == (B, H, dh)
    assert err(got, jax_paged_mqa(*[jnp.asarray(a) for a in arrays])) < 1e-5


def test_paged_len_zero_gives_zeros_like_pallas():
    """A sequence of length 0 is 0 in the plain version and the Pallas
    kernel (the jnp oracle gives NaN there, so it is not compared)."""
    rng = np.random.default_rng(5)
    q, pk, pv, table, lens = paged_inputs(rng, 2, 4, 2, 32, 8, 16, 4)
    lens[1] = 0
    arrays = (q, pk, pv, table, lens)
    got = kpaged.paged_mqa(*map(torch.from_numpy, arrays))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    pallas = jax_paged_mqa(*[jnp.asarray(a) for a in arrays])
    assert err(got, pallas) < 1e-5


def attn_params(cfg, rng):
    """One attention layer's parameters, fp32, for both packages."""
    d, dh, h, hk = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, h * dh), "wk": (d, hk * dh), "wv": (d, hk * dh),
              "wo": (h * dh, d), "bq": (h * dh,), "bk": (hk * dh,),
              "bv": (hk * dh,)}
    arrays = {k: (draw(rng, s) / np.float32(np.sqrt(s[0])) if len(s) == 2
                  else draw(rng, s)) for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


@pytest.fixture(scope="module")
def cfgs():
    return (get_arch("qwen2-0.5b").reduced(),
            jax_get_arch("qwen2-0.5b").reduced())


def test_attn_prefill_matches_jax(cfgs):
    cfg, jcfg = cfgs
    rng = np.random.default_rng(7)
    jp, tp = attn_params(cfg, rng)
    x = draw(rng, (2, 29, cfg.d_model))
    jy, jc = jattn.attn_prefill(jp, jnp.asarray(x), jcfg)
    ty, tc = tattn.attn_prefill(tp, torch.from_numpy(x), cfg)
    assert err(ty, jy) < 1e-5
    assert err(tc["k"], jc["k"]) < 1e-5 and err(tc["v"], jc["v"]) < 1e-5


def test_identity_table_decode_matches_jax_attn_decode(cfgs):
    """The port's decode (in-place write at pos, then the paged kernel
    over the dense cache seen as pages) against the JAX jnp decode over
    the same dense cache."""
    cfg, jcfg = cfgs
    rng = np.random.default_rng(8)
    jp, tp = attn_params(cfg, rng)
    B, S = 3, 48
    x = draw(rng, (B, 1, cfg.d_model))
    k, v = (draw(rng, (B, S, cfg.n_kv_heads, cfg.head_dim))
            for _ in range(2))
    pos = np.array([0, 17, 46])
    jy, jc = jattn.attn_decode(jp, jnp.asarray(x),
                               {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                               jcfg, pos=jnp.asarray(pos, jnp.int32))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    ty, tc = tattn.attn_decode(tp, torch.from_numpy(x), cache, cfg,
                               pos=torch.from_numpy(pos), page_size=16)
    assert tc["k"] is cache["k"]  # written in place
    assert err(ty, jy) < 1e-5
    assert err(tc["k"], jc["k"]) < 1e-5 and err(tc["v"], jc["v"]) < 1e-5
    with pytest.raises(ValueError, match="pages"):
        tattn.attn_decode(tp, torch.from_numpy(x), cache, cfg,
                          pos=torch.from_numpy(pos), page_size=20)


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 4, 4, 32)
    k = torch.zeros(1, 4, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        kflash.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        kflash.flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="window"):
        kflash.flash_attention(q, q, q, window=0)
    qd = torch.zeros(2, 4, 32)
    pages = torch.zeros(4, 16, 2, 32)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kpaged.paged_mqa(qd, pages, pages, table.long(),
                         torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="seq_lens"):
        kpaged.paged_mqa(qd, pages, pages, table,
                         torch.ones(3, dtype=torch.int32))
    assert kflash.LAUNCHES["flash_attention"] == 0
    assert kpaged.LAUNCHES["paged_attention"] == 0
