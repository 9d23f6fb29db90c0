"""The port's hybrid family (repro_torch, device="cpu") against the JAX
package: jamba-1.5-large-398b's reduced configuration, one superblock of
8 sublayers (Mamba mixers around one attention mixer at position 4, MoE
on the odd positions, a dense MLP on the even ones), d_model 128.

The JAX package's ``LM`` initialises it from ``PRNGKey``;
``convert.lm_params_from_arrays`` carries its parameters into the port's
``LM``, and both run the same tokens, drawn with numpy from a seed.
Caches have the JAX package's layout (``blocks.l<i>`` per pattern
position, stacked over the repeats when the superblock repeats), so
they compare leaf by leaf.  Tolerances:

* fp32-cast parameters: logits and every cache leaf within 1e-4 of
  their largest magnitude (the same arithmetic in another order);
* the bf16 parameters as ``init_params`` makes them: 8 layers of
  random weights amplify bf16 rounding, so that the JAX model's own bf16
  logits lie 4.2-8.6% of the largest logit from its fp32 run on the same
  weights (three seeds), and the port's bf16 logits 4.5-5.4% from the
  JAX bf16 ones.  The scan, the attention softmax weights and the MoE
  combine round to bf16 at other points in the two packages.  So the
  port's bf16 logits are held to the JAX fp32 run of the same weights:
  no further from it than 1.5 times the JAX bf16 logits are (measured
  0.78-1.13 times).

The servers run the fp32 weights: served tokens, every stat but the
host-clock recovery time, and the PMem counters must be equal.  Prompts
of 1 and 8 (H) tokens break the JAX ``Server``, which pads every cache
leaf whose axis -3 equals the prompt length, and so takes Mamba's conv
tail (axis -3 the batch, 1) or its ssm state (axis -3 the heads, 8) for
a token axis (ROADMAP Queue 3, item 7); the port pads only ``k`` and
``v`` and serves them, with the tokens its own ``LM.prefill`` and
``decode_step`` loop gives.
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
from repro_torch.models.model import group_plan
from repro_torch.serving import Server
from repro_torch.serving.engine import _pad_caches

ARCH = "jamba-1.5-large-398b"
TIMED = "recovery_time_to_first_served_us"
TOL = 1e-4
BF16_RATIO = 1.5
MAMBA = ("ssm", "conv")


def configs(n_layers=None):
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return cfg, jcfg


def pair(dtype, seed=0, n_layers=None):
    cfg, jcfg = configs(n_layers)
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


def close(t, j):
    return gap(t, j) <= TOL


def logits_close(dtype, tl, jl, jl32):
    """fp32: within TOL; bf16: against the JAX fp32 logits ``jl32``, no
    further than ``BF16_RATIO`` times the JAX bf16 logits are."""
    if dtype == "fp32":
        return close(tl, jl)
    return gap(tl, jl32) <= BF16_RATIO * gap(jl, jl32)


def test_group_plan_and_state_dict_carry_across():
    """The superblock's pattern, and the converted tree's names, shapes
    and dtypes equal the port's own, with one and with two repeats."""
    for n_layers in (None, 16):
        cfg, jcfg = configs(n_layers)
        (_, pattern, repeat), = group_plan(cfg)
        assert pattern == [("mamba", "mlp"), ("mamba", "moe"),
                           ("mamba", "mlp"), ("mamba", "moe"),
                           ("attn", "mlp"), ("mamba", "moe"),
                           ("mamba", "mlp"), ("mamba", "moe")]
        assert repeat == cfg.n_layers // 8
        jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init_params(
            jax.random.PRNGKey(0)))
        sd = lm_params_from_arrays(jp, cfg)
        own = LM(cfg, device="cpu").state_dict()
        assert sorted(sd) == sorted(own)
        for name, t in own.items():
            assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, \
                name
    # layer 9 is position 1 of the second repeat: the JAX leaf [1]
    assert torch.equal(sd["layers.9.moe.w_up"].float(), torch.from_numpy(
        np.asarray(jp["blocks"]["l1"]["moe"]["w_up"][1], np.float32)))
    assert own["layers.12.attn.wq"].dtype == torch.bfloat16
    for name in ("dt_bias", "A_log", "D"):
        assert own[f"layers.0.mamba.{name}"].dtype == torch.float32


@pytest.mark.parametrize("dtype,n_layers", [("fp32", None), ("bf16", None),
                                            ("fp32", 16)])
def test_prefill_and_decode_match_jax(dtype, n_layers):
    """Prefill logits and every cache leaf (the attention cache, each
    Mamba position's ssm and conv), then five teacher-forced decode
    steps over the attention cache padded to 48 slots."""
    cfg, jm, jp, lm = pair(dtype, n_layers=n_layers)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(1)
    T, S = 37, 48
    toks = rng.integers(0, cfg.vocab, size=(1, T + 5))
    batch = {"tokens": jnp.asarray(toks[:, :T], jnp.int32)}
    jl, jc = jm.prefill(jp, batch, T)
    jl32, jc32 = jm.prefill(jp32, batch, T)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks[:, :T])}, T)
    assert tl.shape == (1, cfg.vocab) and tl.dtype == lm.dtype
    assert logits_close(dtype, tl, jl, jl32)
    assert sorted(tc["blocks"]) == sorted(jc["blocks"]) == \
        [f"l{i}" for i in range(8)]
    for pos_name, leaves in jc["blocks"].items():
        for name, j in leaves.items():
            t = tc["blocks"][pos_name][name]
            assert t.shape == j.shape, (pos_name, name)
            assert str(t.dtype) == f"torch.{j.dtype}", (pos_name, name)
            if dtype == "fp32":
                assert close(t, j), (pos_name, name)

    def pad(c):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.pad(a, [(0, 0)] * (a.ndim - 3)
                                    + [(0, S - T), (0, 0), (0, 0)])
            if path[-1].key in ("k", "v") else a, c)

    jc, jc32, tc = pad(jc), pad(jc32), _pad_caches(tc, T, S)
    for pos in range(T, T + 5):
        tok = jnp.asarray(toks[:, pos], jnp.int32)
        at = jnp.asarray([pos], jnp.int32)
        jl, jc = jm.decode_step(jp, tok, jc, at)
        jl32, jc32 = jm.decode_step(jp32, tok, jc32, at)
        tl, tc = lm.decode_step(torch.from_numpy(toks[:, pos]), tc,
                                torch.tensor([pos]))
        assert logits_close(dtype, tl, jl, jl32), pos
    if dtype == "fp32":
        for pos_name, leaves in jc["blocks"].items():
            for name, j in leaves.items():
                assert close(tc["blocks"][pos_name][name], j), \
                    (pos_name, name)


def test_init_caches_and_batched_decode():
    """Zeroed caches in the prefill's layout; two sequences decode in
    one step as each does alone."""
    cfg, _, _, lm = pair("fp32", seed=2)
    caches = lm.init_caches(2, 32)
    mamba, att = caches["blocks"]["l0"], caches["blocks"]["l4"]
    assert set(mamba) == set(MAMBA) and set(att) == {"k", "v"}
    assert mamba["ssm"].dtype == torch.float32 and \
        mamba["conv"].dtype == lm.dtype
    assert att["k"].shape == (2, 32, cfg.n_kv_heads, cfg.head_dim)
    toks, pos = torch.tensor([3, 9]), torch.tensor([0, 0])
    both, _ = lm.decode_step(toks, caches, pos)
    for b in range(2):
        alone, _ = lm.decode_step(toks[b:b + 1], lm.init_caches(1, 32),
                                  pos[b:b + 1])
        assert float((alone[0] - both[b]).abs().max()) < 1e-5


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
    (not 1 or 8), a powerfail between the two batches."""
    cfg = served[0]
    batch = prompts(cfg, 6, (9, 17, 12), prefix=8)
    js, ts = servers(served)
    jreqs = drain(js, [batch, batch], pipelined=pipelined, crash=True)
    treqs = drain(ts, [batch, batch], pipelined=pipelined, crash=True)
    assert_same(js, ts, jreqs, treqs)
    assert ts.stats["prefix_hits"] > 0 and ts.stats["decode_steps"] == 18


def own_loop(lm, prompt, n):
    """Greedy tokens from the port's LM alone: prefill, then decode over
    the attention cache padded to whole pages."""
    logits, caches = lm.prefill({"tokens": torch.tensor([prompt])},
                                len(prompt))
    caches = _pad_caches(caches, len(prompt), 40)
    out = [int(torch.argmax(logits[0]))]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, caches = lm.decode_step(torch.tensor([out[-1]]), caches,
                                        torch.tensor([pos]), page_size=8)
        out.append(int(torch.argmax(logits[0])))
    return out


@pytest.mark.parametrize("n", [1, 8])
def test_prompts_of_1_and_h_tokens(served, n):
    """1 token (the conv tail's axis -3 is the batch, 1) and 8 (H, the
    ssm state's axis -3): the JAX Server's padding rule takes them for a
    token axis and raises; the port's Server serves them with its own
    model's tokens."""
    cfg, _, _, lm = served
    assert cfg.mamba.expand * cfg.d_model // cfg.mamba.head_dim == 8
    (p,) = prompts(cfg, n, (n,))
    js, ts = servers(served)
    js.submit(p, max_new=4)
    with pytest.raises((TypeError, ValueError)):
        js.run_until_drained(max_len=40)
    ts.submit(p, max_new=4)
    (req,) = ts.queue
    ts.run_until_drained(max_len=40)
    assert req.done and req.out == own_loop(lm, p, 4)


def test_serve_driver_runs_the_hybrid_reduced_and_refuses_full_width():
    """``serve`` builds the hybrid (here reduced, on the CPU) and drains
    its prompts across a crash; at full width one superblock is 90 GB in
    bf16, more than one card, and it raises before drawing weights."""
    server = serve(ARCH, device="cpu", reduced=True, n_requests=3,
                   prompt_len=20, max_new=3, crash_midway=True,
                   verbose=False)
    assert server.stats["decode_steps"] == 6
    assert server.stats["prefix_hits"] > 0
    with pytest.raises(NotImplementedError, match="90.3 GB"):
        serve(ARCH, device="cpu")
