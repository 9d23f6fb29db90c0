"""The port's MoE family (repro_torch, device="cpu") against the JAX
package: deepseek-moe-16b (a dense layer 0, then MoE layers with 4
routed experts top-2 and one shared expert at ``reduced()``), the same
at 4 layers (its ``blocks`` group stacked over 3 repeats), and
mixtral-8x22b (every layer MoE, 4 experts top-2, a sliding window of 64
at ``reduced()``), with starcoder2-15b (dense, window 64) beside them
where the layer groups and the converter are checked.

The JAX package's ``LM`` initialises each from ``PRNGKey``;
``convert.lm_params_from_arrays`` carries its parameters into the port's
``LM``, and both run the same tokens, drawn with numpy from a seed.
Tolerances, as in tests/test_torch_hybrid.py:

* fp32-cast parameters: logits within 1e-4 of their largest magnitude
  (the same arithmetic in another order);
* the bf16 parameters as ``init_params`` makes them: the two packages
  round to bf16 at other points (the attention softmax weights, the MoE
  combine), so the port's bf16 logits are held to the JAX fp32 run of
  the same weights: no further from it than 1.5 times the JAX bf16
  logits are.  A router near-tie that bf16 rounding flips sends a token
  to another expert, in either package's bf16 run (seen at DeepSeek's
  4 layers: a gap of 0.0004 between the 2nd and 3rd probability flipped
  in the port, and another flipped in the JAX run, each moving the
  logits by some 30% of the largest); the port's routing is compared
  with its fp32 run's, and from the first flip on, which the bf16
  probabilities' own error must explain, the logits are held finite
  only.

Prompts of 62 and 90 tokens put the decode steps before, at and past
Mixtral's reduced window (64).  The servers run the fp32 weights:
served tokens, every stat but the host-clock recovery time, and the
PMem counters must be equal, blocking and pipelined, with a powerfail
between two batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.core import PMem as JPMem
from repro.models.model import build_model as jax_build_model
from repro.models.model import group_plan as jax_group_plan
from repro.serving.engine import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import PMem
from repro_torch.launch.serve import check_fits, serve
from repro_torch.models import LM
from repro_torch.models import ffn as tffn
from repro_torch.models.model import check_ported, group_plan
from repro_torch.serving import Server
from repro_torch.serving.engine import _pad_caches

DEEPSEEK, MIXTRAL, STARCODER = ("deepseek-moe-16b", "mixtral-8x22b",
                                "starcoder2-15b")
TIMED = "recovery_time_to_first_served_us"
TOL = 1e-4
BF16_RATIO = 1.5
# (arch, layers): the reduced configurations, and DeepSeek at 4 layers
CASES = [(DEEPSEEK, None), (DEEPSEEK, 4), (MIXTRAL, None),
         (STARCODER, None)]
IDS = ["deepseek", "deepseek-4-layers", "mixtral", "starcoder2"]


def configs(arch, n_layers=None):
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return cfg, jcfg


def pair(arch, dtype, n_layers=None, seed=0):
    """(config, JAX model, JAX params, port LM) on the same weights."""
    cfg, jcfg = configs(arch, n_layers)
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


def logits_close(dtype, tl, jl, jl32):
    """fp32: within TOL; bf16: against the JAX fp32 logits ``jl32``, no
    further than ``BF16_RATIO`` times the JAX bf16 logits are."""
    if dtype == "fp32":
        return gap(tl, jl) <= TOL
    return gap(tl, jl32) <= BF16_RATIO * gap(jl, jl32)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_group_plan_equals_jax(arch, n_layers):
    cfg, jcfg = configs(arch, n_layers)
    assert group_plan(cfg) == jax_group_plan(jcfg)
    full = group_plan(get_arch(arch))
    assert full == jax_group_plan(jax_get_arch(arch))
    if arch == DEEPSEEK:
        assert [(g, r) for g, _, r in full] == [("dense0", 1), ("blocks", 27)]


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_state_dict_round_trips_every_leaf(arch, n_layers):
    """Every JAX leaf, shared experts included, lands at its port name
    with its value, shape and dtype, once per repeat; the names are the
    port's own, and nothing else is made."""
    cfg, jcfg = configs(arch, n_layers)
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init_params(
        jax.random.PRNGKey(3)))
    sd = lm_params_from_arrays(jp, cfg)
    own = LM(cfg, device="cpu").state_dict()
    assert sorted(sd) == sorted(own)
    for name, t in own.items():
        assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, name
    seen = 0
    first = 0
    for gname, pattern, repeat in group_plan(cfg):
        for i in range(len(pattern)):
            flat = jax.tree_util.tree_flatten_with_path(jp[gname][f"l{i}"])
            for path, leaf in flat[0]:
                keys = [k.key for k in path]
                name = (f"{keys[0]}.{keys[1]}" if len(keys) == 2 else
                        f"{keys[0]}_{keys[1]}.{keys[2]}")
                for r in range(repeat):
                    want = leaf[r] if repeat > 1 else leaf
                    got = sd[f"layers.{first + r * len(pattern) + i}.{name}"]
                    assert np.array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32)), name
                    seen += 1
        first += repeat * len(pattern)
    assert seen == len([k for k in sd if k.startswith("layers.")])
    if arch == DEEPSEEK:
        assert "layers.1.moe_shared.w_gate" in sd
        assert "layers.0.ffn.w_up" in sd and "layers.0.moe.router" not in sd


def first_flip(r16, r32, K):
    """Where the bf16 run routed a token to another expert set than the
    fp32 run of the same weights: None if no MoE layer did; else whether
    the first layer that did (the later ones take its output) did so only
    where its fp32 K-th and (K+1)-th router probabilities lie within
    twice the token's largest bf16-fp32 probability difference, a
    near-tie that bf16 rounding flips."""
    for (e16, p16), (e32, p32) in zip(r16, r32):
        same = (e16.sort(-1).values == e32.sort(-1).values).all(-1)
        if bool(same.all()):
            continue
        top = p32.sort(-1, descending=True).values
        tie = top[:, K - 1] - top[:, K]
        noise = (p16 - p32).abs().amax(-1)
        return bool((tie[~same] <= 2 * noise[~same]).all())
    return None


@pytest.fixture
def routes(monkeypatch):
    """Each MoE layer's routing in a call: ``routes(fn)`` returns fn's
    result and a list of (experts [S, K], fp32 probabilities [S, E]) in
    layer order."""
    real = tffn._route
    seen = []

    def spy(p, xt, cfg):
        out = real(p, xt, cfg)
        seen.append((out[3], out[1].float()))
        return out

    monkeypatch.setattr(tffn, "_route", spy)

    def run(fn):
        seen.clear()
        return fn(), list(seen)
    return run


@pytest.mark.parametrize("T", [62, 90], ids=["before-window", "past-window"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch,n_layers", CASES[:3], ids=IDS[:3])
def test_prefill_and_decode_match_jax(arch, n_layers, dtype, T, routes):
    """Prefill logits and every cache leaf, then four teacher-forced
    decode steps (positions T .. T + 3) over caches padded to whole
    pages, against the JAX ``LM``.  In bf16 a router near-tie may flip a
    token's expert set against the fp32 run (as it may in the JAX bf16
    run): from the first such flip on, which bf16 rounding must explain
    (``first_flip``), the logits are only held finite."""
    cfg, jm, jp, lm = pair(arch, dtype, n_layers)
    lm32 = pair(arch, "fp32", n_layers)[3]
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(T)
    S = 96
    toks = rng.integers(0, cfg.vocab, size=(1, T + 4))
    flipped = []

    def check(what, tl, jl, jl32, r16, r32):
        assert bool(torch.isfinite(tl.float()).all()), what
        if dtype == "fp32":
            assert gap(tl, jl) <= TOL, what
            return
        if not flipped:
            flip = first_flip(r16, r32, cfg.moe.top_k)
            if flip is None:
                assert logits_close(dtype, tl, jl, jl32), what
            else:
                assert flip, f"{what}: a routing flip bf16 does not explain"
                flipped.append(what)

    batch = {"tokens": jnp.asarray(toks[:, :T], jnp.int32)}
    tokens = {"tokens": torch.from_numpy(toks[:, :T])}
    jl, jc = jm.prefill(jp, batch, T)
    jl32, jc32 = jm.prefill(jp32, batch, T)
    (tl, tc), r16 = routes(lambda: lm.prefill(tokens, T))
    (_, tc32), r32 = routes(lambda: lm32.prefill(tokens, T))
    assert tl.shape == (1, cfg.vocab) and tl.dtype == lm.dtype
    check("prefill", tl, jl, jl32, r16, r32)
    assert sorted(tc) == sorted(jc)
    for gname, group in jc.items():
        for pos_name, leaves in group.items():
            for name, j in leaves.items():
                t = tc[gname][pos_name][name]
                assert t.shape == j.shape, (gname, pos_name, name)
                if dtype == "fp32":
                    assert gap(t, j) <= TOL, (gname, pos_name, name)

    def pad(c):
        return jax.tree.map(
            lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 3)
                              + [(0, S - T), (0, 0), (0, 0)]), c)

    jc, jc32 = pad(jc), pad(jc32)
    tc, tc32 = _pad_caches(tc, T, S), _pad_caches(tc32, T, S)
    for pos in range(T, T + 4):
        tok = jnp.asarray(toks[:, pos], jnp.int32)
        at = jnp.asarray([pos], jnp.int32)
        jl, jc = jm.decode_step(jp, tok, jc, at)
        jl32, jc32 = jm.decode_step(jp32, tok, jc32, at)
        ttok, tpos = torch.from_numpy(toks[:, pos]), torch.tensor([pos])
        (tl, tc), r16 = routes(lambda: lm.decode_step(ttok, tc, tpos))
        (_, tc32), r32 = routes(lambda: lm32.decode_step(ttok, tc32, tpos))
        check(f"decode at {pos}", tl, jl, jl32, r16, r32)


def test_init_caches_are_keyed_by_group():
    """DeepSeek at 4 layers: the dense layer's cache under ``dense0``,
    the MoE layers' stacked over their 3 repeats under ``blocks``, as the
    JAX package's ``init_caches`` lays them out; two sequences decode in
    one step as each does alone."""
    cfg, jm, _, lm = pair(DEEPSEEK, "fp32", 4)
    caches = lm.init_caches(2, 32)
    jcaches = jm.init_caches(2, 32)
    assert sorted(caches) == sorted(jcaches) == ["blocks", "dense0"]
    for gname, group in jcaches.items():
        for pos_name, leaves in group.items():
            for name, j in leaves.items():
                assert caches[gname][pos_name][name].shape == j.shape
    assert caches["blocks"]["l0"]["k"].shape == (3, 2, 32, cfg.n_kv_heads,
                                                 cfg.head_dim)
    toks, pos = torch.tensor([3, 9]), torch.tensor([0, 0])
    both, _ = lm.decode_step(toks, caches, pos)
    for b in range(2):
        alone, _ = lm.decode_step(toks[b:b + 1], lm.init_caches(1, 32),
                                  pos[b:b + 1])
        assert float((alone[0] - both[b]).abs().max()) < 1e-5


# -- serving ------------------------------------------------------------

def prompts(cfg, seed, lengths, prefix=0):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, cfg.vocab, prefix)]
    return [shared + [int(t) for t in rng.integers(1, cfg.vocab, n - prefix)]
            for n in lengths]


def drain(server, batches, *, pipelined, max_len=96, max_new=4):
    """Each batch submitted and drained, a powerfail between batches."""
    reqs = []
    for i, batch in enumerate(batches):
        for p in batch:
            server.submit(p, max_new=max_new)
        reqs += list(server.queue)
        server.run_until_drained(max_len=max_len, pipelined=pipelined)
        if i < len(batches) - 1:
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
@pytest.mark.parametrize("arch", [DEEPSEEK, MIXTRAL])
def test_server_matches_jax(arch, pipelined):
    """Prompts of 40 and 90 tokens sharing an 8-token prefix (the second
    past Mixtral's reduced window), a powerfail between two batches."""
    cfg, jm, jp, lm = pair(arch, "fp32")
    batch = prompts(cfg, 5, (40, 90), prefix=8)
    kw = {"page_size": 8, "n_pages": 128}
    js = JServer(jm, jp, pmem=JPMem(), **kw)
    ts = Server(lm, pmem=PMem(), **kw)
    jreqs = drain(js, [batch, batch], pipelined=pipelined)
    treqs = drain(ts, [batch, batch], pipelined=pipelined)
    assert_same(js, ts, jreqs, treqs)
    assert ts.stats["prefix_hits"] > 0 and ts.stats["decode_steps"] == 12


def test_check_ported_takes_every_configuration():
    """Every configuration of the repo builds, Whisper's
    (encoder-decoder) and InternVL's (VLM) included, at ``reduced()``
    with the layer grouping the JAX package gives it."""
    for name in jax_all_archs():
        cfg = get_arch(name).reduced()
        check_ported(cfg)
        assert group_plan(cfg) == jax_group_plan(jax_get_arch(name)
                                                 .reduced()), name


def test_serve_refuses_full_width_mixtral_and_serves_it_reduced():
    """``serve`` draws no weights for a model that does not fit the
    card (Mixtral-8x22B: 281.3 GB in bf16) and serves its reduced form
    across a crash; DeepSeek-MoE and StarCoder2 fit (32.6 and 31.9 GB)
    and are not refused."""
    with pytest.raises(NotImplementedError, match="281.3 GB"):
        serve(MIXTRAL, device="cpu")
    for arch in (MIXTRAL, DEEPSEEK):
        server = serve(arch, device="cpu", reduced=True, n_requests=3,
                       prompt_len=20, max_new=3, crash_midway=True,
                       verbose=False)
        assert server.stats["decode_steps"] == 6
        assert server.stats["prefix_hits"] > 0
    for arch in (DEEPSEEK, STARCODER):
        check_fits(get_arch(arch))
