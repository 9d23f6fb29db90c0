"""Sliding-window attention in the port (repro_torch, device="cpu")
against the JAX package: starcoder2-15b (dense, GQA, LayerNorm, GELU
MLP, window 64 at ``reduced()``) and mixtral-8x22b's reduced window.

* ``attn_decode`` with a window against the JAX ``attn_decode`` (whose
  mask keeps ``kpos <= pos`` and ``kpos > pos - window``) at pos =
  window - 1, window and window + 17: outputs and written caches within
  1e-5 of their largest magnitude (fp32);
* ``paged_attention_plain(window=...)`` against that mask written out
  over a dense cache, through shuffled pages, within 1e-5; a window of
  at least the length equals no window, and a window below 1 raises;
* StarCoder2's ``LM``: prefill logits and caches, then four decode
  steps before, at and past the window (prompts of 62 and 90 tokens):
  fp32 within 1e-4 of the largest logit; bf16 no further from the JAX
  fp32 run than 1.5 times the JAX bf16 run (tests/test_torch_hybrid.py's
  rule);
* StarCoder2's ``Server`` against the JAX ``Server`` with fp32 weights:
  prompts of 40 and 90 tokens, blocking and pipelined, a powerfail
  between two batches: tokens, stats (but the host-clock recovery time)
  and PMem counters equal.

Inputs are drawn with numpy from a seed.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import PMem as JPMem
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import PMem
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.serving import Server
from repro_torch.serving.engine import _pad_caches

STARCODER, MIXTRAL = "starcoder2-15b", "mixtral-8x22b"
TIMED = "recovery_time_to_first_served_us"
TOL = 1e-4
KERNEL_TOL = 1e-5
BF16_RATIO = 1.5


def pair(arch, dtype, seed=0):
    """(config, JAX model, JAX params, port LM) on the same weights."""
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    return cfg, jm, jp, lm


def gap(t, j):
    """Largest difference over the largest |j|."""
    t = t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))
    j = np.asarray(jnp.asarray(j, jnp.float32))
    return float(np.abs(t - j).max()) / float(np.abs(j).max())


def test_reduced_windows():
    assert get_arch(STARCODER).reduced().sliding_window == 64
    assert get_arch(MIXTRAL).reduced().sliding_window == 64
    assert get_arch(STARCODER).sliding_window == 4096


@pytest.mark.parametrize("arch", [STARCODER, MIXTRAL])
def test_attn_decode_window_matches_jax(arch):
    """Three sequences at pos = window - 1 (every key live), window (key
    0 drops out) and window + 17, over a cache of 96 slots whose slots
    past pos hold noise; layer 0's weights."""
    cfg, _, jp, lm = pair(arch, "fp32")
    w = cfg.sliding_window
    rng = np.random.default_rng(w)
    B, S = 3, 96
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    pos = np.array([w - 1, w, w + 17])
    jp0 = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    jy, jc = jattn.attn_decode(jp0, jnp.asarray(x),
                               {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                               cfg, pos=jnp.asarray(pos, jnp.int32))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    ty, tc = tattn.attn_decode(lm.layers[0].attn, torch.from_numpy(x),
                               cache, cfg, pos=torch.from_numpy(pos))
    assert gap(ty, jy) <= KERNEL_TOL
    for name in ("k", "v"):
        assert gap(tc[name], jc[name]) <= KERNEL_TOL
    # the window bites: without it the output moves
    unwindowed = dataclasses.replace(cfg, sliding_window=None)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    full, _ = tattn.attn_decode(lm.layers[0].attn, torch.from_numpy(x),
                                cache, unwindowed, pos=torch.from_numpy(pos))
    assert gap(full[0], jy[0]) <= KERNEL_TOL  # pos = w - 1: all live
    assert gap(full[1:], jy[1:]) > 100 * KERNEL_TOL


def masked_reference(q, k, v, lens, window):
    """The JAX decode's mask over dense caches, in numpy: key j live for
    j <= pos and j > pos - window (pos = len - 1)."""
    B, H, dh = q.shape
    G = H // k.shape[2]
    out = np.zeros((B, H, dh))
    for b in range(B):
        j = np.arange(k.shape[1])
        pos = lens[b] - 1
        live = (j <= pos) & (j > pos - window)
        for h in range(H):
            s = k[b, :, h // G] @ q[b, h] / math.sqrt(dh)
            s = np.where(live, s, -np.inf)
            p = np.exp(s - s.max())
            out[b, h] = p @ v[b, :, h // G] / p.sum()
    return out


@pytest.mark.parametrize("H,Hk,dh,PS,window,lens", [
    (48, 4, 128, 16, 64, [63, 64, 81]),     # StarCoder2's heads
    (4, 1, 32, 16, 64, [64, 65, 200]),      # Mixtral reduced
    (4, 1, 32, 16, 20, [7, 20, 21, 37]),    # a window mid-page
    (4, 1, 32, 16, 32, [48, 49, 200]),      # starts on a page edge
    (4, 2, 64, 8, 1, [1, 9, 100]),          # the newest key alone
])
def test_paged_plain_window_matches_jax_mask(H, Hk, dh, PS, window, lens):
    rng = np.random.default_rng(window + H)
    B, S = len(lens), 208
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hk, dh)).astype(np.float32)
            for _ in range(2))
    n = S // PS
    perm = rng.permutation(B * n)  # each logical page at a shuffled page
    pages_k = np.zeros((B * n, PS, Hk, dh), np.float32)
    pages_v = np.zeros_like(pages_k)
    table = perm.reshape(B, n).astype(np.int32)
    for b in range(B):
        for i in range(n):
            pages_k[table[b, i]] = k[b, i * PS:(i + 1) * PS]
            pages_v[table[b, i]] = v[b, i * PS:(i + 1) * PS]
    lt = torch.tensor(lens, dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(pages_k),
            torch.from_numpy(pages_v), torch.from_numpy(table), lt)
    got = kpaged.paged_attention_plain(*args, window=window)
    want = masked_reference(q, k, v, lens, window)
    assert np.abs(got.numpy() - want).max() <= KERNEL_TOL * np.abs(want).max()
    assert torch.equal(kpaged.paged_mqa(*args, window), got)
    # a window of at least the length is no window
    wide = kpaged.paged_attention_plain(*args, window=max(lens))
    assert torch.equal(wide, kpaged.paged_attention_plain(*args))


@pytest.mark.parametrize("window", [0, -3])
def test_window_below_one_raises(window):
    q = torch.zeros(1, 4, 32)
    pages = torch.zeros(2, 16, 1, 32)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    for fn in (kpaged.paged_attention_plain, kpaged.paged_attention,
               kpaged.paged_mqa):
        with pytest.raises(ValueError, match="window"):
            fn(q, pages, pages, table, lens, window)


@pytest.mark.parametrize("T", [62, 90], ids=["before-window", "past-window"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_starcoder2_prefill_and_decode_match_jax(dtype, T):
    """Prefill logits and caches, then four teacher-forced decode steps
    over caches padded to 96 slots, against the JAX ``LM``: at T = 62 the
    steps run at positions 62-65, before, at and past the window of 64;
    at T = 90 the prefill's own window bites too."""
    cfg, jm, jp, lm = pair(STARCODER, dtype)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(T + 1)
    S = 96
    toks = rng.integers(0, cfg.vocab, size=(1, T + 4))

    def close(tl, jl, jl32):
        if dtype == "fp32":
            return gap(tl, jl) <= TOL
        return gap(tl, jl32) <= BF16_RATIO * gap(jl, jl32)

    batch = {"tokens": jnp.asarray(toks[:, :T], jnp.int32)}
    jl, jc = jm.prefill(jp, batch, T)
    jl32, jc32 = jm.prefill(jp32, batch, T)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks[:, :T])}, T)
    assert close(tl, jl, jl32)
    for name, j in jc["blocks"]["l0"].items():
        t = tc["blocks"]["l0"][name]
        assert t.shape == j.shape
        if dtype == "fp32":
            assert gap(t, j) <= TOL, name

    def pad(c):
        return jax.tree.map(
            lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 3)
                              + [(0, S - T), (0, 0), (0, 0)]), c)

    jc, jc32, tc = pad(jc), pad(jc32), _pad_caches(tc, T, S)
    for pos in range(T, T + 4):
        tok = jnp.asarray(toks[:, pos], jnp.int32)
        at = jnp.asarray([pos], jnp.int32)
        jl, jc = jm.decode_step(jp, tok, jc, at)
        jl32, jc32 = jm.decode_step(jp32, tok, jc32, at)
        tl, tc = lm.decode_step(torch.from_numpy(toks[:, pos]), tc,
                                torch.tensor([pos]))
        assert close(tl, jl, jl32), pos


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["blocking", "pipelined"])
def test_starcoder2_server_matches_jax(pipelined):
    """Prompts of 40 and 90 tokens sharing an 8-token prefix (the second
    past the window), a powerfail between two batches."""
    cfg, jm, jp, lm = pair(STARCODER, "fp32")
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(1, cfg.vocab, 8)]
    batch = [shared + [int(t) for t in rng.integers(1, cfg.vocab, n - 8)]
             for n in (40, 90)]
    kw = {"page_size": 8, "n_pages": 128}
    servers = (JServer(jm, jp, pmem=JPMem(), **kw),
               Server(lm, pmem=PMem(), **kw))
    runs = []
    for server in servers:
        reqs = []
        for i in range(2):
            for p in batch:
                server.submit(p, max_new=4)
            reqs += list(server.queue)
            server.run_until_drained(max_len=96, pipelined=pipelined)
            if i == 0:
                server.crash_and_recover()
        runs.append(reqs)
    (js, ts), (jreqs, treqs) = servers, runs
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == 4 for r in treqs)
    drop = lambda st: {k: v for k, v in dict(st).items() if k != TIMED}
    assert drop(ts.stats) == drop(js.stats)
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert ts.stats["prefix_hits"] > 0 and ts.stats["decode_steps"] == 12
