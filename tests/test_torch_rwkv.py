"""The port's RWKV6 model and its serving (repro_torch, device="cpu")
against the JAX package.

The JAX package's ``LM`` initialises RWKV6-7B's reduced configuration
(2 layers, d_model 128, 4 heads of 32) from ``PRNGKey``;
``convert.lm_params_from_arrays`` carries its parameters into the port's
``LM``, and both run the same tokens, drawn with numpy from a seed.
Tolerances:

* fp32-cast parameters: logits and the three state leaves within 1e-4
  (the same arithmetic in another order: the port's WKV runs the
  step-by-step recurrence, the JAX model its chunked jnp form);
* the bf16 parameters as ``init_params`` makes them: each compared
  tensor within 2e-2 of its largest magnitude, about five bf16 unit
  roundoffs (2^-8).  The JAX model rounds its in-chunk WKV terms and
  the one-step decode's r, k, v products to bf16 at other points than
  the port, which keeps the WKV in fp32 and rounds once; over three
  seeds the two differ by up to 1.0%.

The servers run the fp32 weights: served tokens, every stat but the
host-clock recovery time, and the PMem counters must be equal.  Prompts
of exactly L (layers) or H (heads) tokens break the JAX ``Server``,
which pads every cache leaf whose axis -3 equals the prompt length
(ROADMAP Queue 3, item 6); the port pads only ``k`` and ``v`` and
serves them, with the tokens its own ``LM.prefill`` and ``decode_step``
loop gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import PMem as JPMem
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import PMem
from repro_torch.launch.serve import serve
from repro_torch.models import LM
from repro_torch.serving import Server

ARCH = "rwkv6-7b"
LEAVES = ("wkv", "shift_tm", "shift_cm")
TIMED = "recovery_time_to_first_served_us"


def pair(dtype, seed=0):
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    return cfg, jm, jp, lm


def close(dtype, t, j):
    j = np.asarray(j, np.float32)
    e = float(np.abs(t.float().numpy() - j).max())
    return e < (1e-4 if dtype == "fp32" else 2e-2 * np.abs(j).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_state_and_decode_match_jax(dtype):
    """Prefill logits and the three state leaves, then five
    teacher-forced decode steps (the same next token fed to both)."""
    cfg, jm, jp, lm = pair(dtype)
    rng = np.random.default_rng(1)
    T = 37
    toks = rng.integers(0, cfg.vocab, size=(1, T + 5))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T], jnp.int32)},
                        T)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks[:, :T])}, T)
    assert tl.shape == (1, cfg.vocab) and tl.dtype == lm.dtype
    assert close(dtype, tl, jl)
    H, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    shapes = {"wkv": (cfg.n_layers, 1, H, dh, dh),
              "shift_tm": (cfg.n_layers, 1, cfg.d_model),
              "shift_cm": (cfg.n_layers, 1, cfg.d_model)}
    for name in LEAVES:
        t, j = tc["blocks"]["l0"][name], jc["blocks"]["l0"][name]
        assert t.shape == j.shape == shapes[name], name
        assert str(t.dtype) == f"torch.{j.dtype}", name
        assert close(dtype, t, j), name
    for pos in range(T, T + 5):
        tok = toks[:, pos]
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray([pos], jnp.int32))
        tl, tc = lm.decode_step(torch.from_numpy(tok), tc,
                                torch.tensor([pos]))
        assert close(dtype, tl, jl), pos
    for name in LEAVES:
        assert close(dtype, tc["blocks"]["l0"][name],
                     jc["blocks"]["l0"][name]), name


def test_init_caches_and_batched_decode():
    """Zeroed state equals a prefill's layout; two sequences decode in
    one step as each does alone."""
    cfg, _, _, lm = pair("fp32", seed=2)
    caches = lm.init_caches(2, 64)
    leaf = caches["blocks"]["l0"]
    assert leaf["wkv"].dtype == torch.float32
    assert leaf["shift_tm"].dtype == lm.dtype
    assert not any(t.any() for t in leaf.values())
    toks = torch.tensor([3, 9])
    both, _ = lm.decode_step(toks, caches, torch.tensor([0, 0]))
    for b in range(2):
        alone, _ = lm.decode_step(toks[b:b + 1], lm.init_caches(1, 64),
                                  torch.tensor([0]))
        assert float((alone[0] - both[b]).abs().max()) < 1e-5


def test_one_layer_params_carry_across():
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=1)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), n_layers=1)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(4)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 11))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 11)
    tl, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 11)
    assert close("fp32", tl, jl)


def test_state_dict_names_dtypes_and_size():
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    sd = lm_params_from_arrays(jp, cfg)
    lm = LM(cfg, device="cpu")
    own = lm.state_dict()
    assert sorted(sd) == sorted(own)
    for name, t in own.items():
        assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, name
    for name in ("w_r", "w_decay", "cm_k", "cm_v"):
        assert own[f"layers.1.rwkv.{name}"].dtype == torch.bfloat16
    for name in ("decay_bias", "bonus_u", "mu", "cm_mu"):
        assert own[f"layers.0.rwkv.{name}"].dtype == torch.float32
    # the config's formula counts 8 vectors of d_model per time mix; the
    # block holds decay_bias, bonus_u (H * dh = d_model) and 4 rows of mu
    d, L = cfg.d_model, cfg.n_layers
    n = sum(p.numel() for p in lm.parameters())
    assert n == cfg.param_count() - 2 * d * L + d  # + the final norm
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab,
            full.rwkv.head_dim) == (32, 4096, 14336, 65536, 64)
    assert full.param_count() == 7_517_765_632


# -- serving ------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    return pair("fp32")


def servers(served, **kw):
    cfg, jm, jp, lm = served
    kw = {"page_size": 8, "n_pages": 128, **kw}
    return (JServer(jm, jp, pmem=JPMem(), **kw),
            Server(lm, pmem=PMem(), **kw))


def prompts(cfg, seed, lengths, prefix=0):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, cfg.vocab, prefix)]
    return [shared + [int(t) for t in rng.integers(1, cfg.vocab, n - prefix)]
            for n in lengths]


def drain(server, batches, *, pipelined=False, crash=False, max_new=4):
    reqs = []
    for i, batch in enumerate(batches):
        for p in batch:
            server.submit(p, max_new=max_new)
        reqs += list(server.queue)
        server.run_until_drained(max_len=40, pipelined=pipelined)
        if crash and i < len(batches) - 1:
            server.crash_and_recover()
    return reqs


def assert_same(js, ts, jreqs, treqs):
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    drop = lambda st: {k: v for k, v in dict(st).items() if k != TIMED}
    assert drop(ts.stats) == drop(js.stats)
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["blocking", "pipelined"])
def test_server_matches_jax(served, pipelined):
    """Prompts sharing an 8-token prefix at lengths the reference serves
    (not 2 or 4), a powerfail between the two batches."""
    cfg = served[0]
    batch = prompts(cfg, 6, (9, 17, 12), prefix=8)
    js, ts = servers(served)
    jreqs = drain(js, [batch, batch], pipelined=pipelined, crash=True)
    treqs = drain(ts, [batch, batch], pipelined=pipelined, crash=True)
    assert_same(js, ts, jreqs, treqs)
    assert ts.stats["prefix_hits"] > 0 and ts.stats["decode_steps"] == 18


def own_loop(lm, prompt, n):
    """Greedy tokens from the port's LM alone: prefill, then decode."""
    logits, caches = lm.prefill({"tokens": torch.tensor([prompt])},
                                len(prompt))
    out = [int(torch.argmax(logits[0]))]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, caches = lm.decode_step(torch.tensor([out[-1]]), caches,
                                        torch.tensor([pos]))
        out.append(int(torch.argmax(logits[0])))
    return out


def test_prompts_of_l_and_h_tokens(served):
    """2 (L) and 4 (H) tokens: the JAX Server's padding rule takes the
    state's layer or head axis for a token axis and raises; the port's
    Server serves them with its own model's tokens."""
    cfg, _, _, lm = served
    L, H = cfg.n_layers, cfg.d_model // cfg.rwkv.head_dim
    assert (L, H) == (2, 4)
    for n in (L, H):
        (p,) = prompts(cfg, n, (n,))
        js, ts = servers(served)
        js.submit(p, max_new=4)
        with pytest.raises((TypeError, ValueError)):
            js.run_until_drained(max_len=40)
        ts.submit(p, max_new=4)
        (req,) = ts.queue
        ts.run_until_drained(max_len=40)
        assert req.done and req.out == own_loop(lm, p, 4)


def test_serve_driver_runs_rwkv(served):
    """``serve`` builds RWKV6 (here reduced, on the CPU) and drains its
    prompts across a crash."""
    server = serve(ARCH, device="cpu", reduced=True, n_requests=3,
                   prompt_len=20, max_new=3, crash_midway=True,
                   verbose=False)
    assert server.stats["decode_steps"] == 6
    assert server.stats["prefix_hits"] > 0
