"""The port's MoE layers (repro_torch, on the CPU) against the JAX
package's ``repro.models.ffn``: ``moe_forward_gshard`` and
``moe_forward_sorted``, output and Switch aux loss.

The JAX package's ``init_moe`` draws the layer from ``PRNGKey`` at the
reduced widths of jamba-1.5-large-398b (4 experts, top 2, d_expert 64,
SwiGLU) and deepseek-moe-16b (the same plus a shared expert); the same
arrays go into the port's functions, with tokens drawn with numpy from
a seed.  Two capacities: the reduced configuration's factor of 8.0,
where nothing drops, and the production factor of 1.25, on inputs
skewed toward a few experts so that assignments drop.  A zero router
makes every probability tie: ``jax.lax.top_k`` takes the lower expert
index first, and so must the port.  With fp32 parameters the outputs
agree within 1e-5 of their largest magnitude and the aux loss within
1e-6 (the same sums in another order); the bf16 parameters as
``init_moe`` makes them route identically here, and their outputs
agree within 2e-2 of the largest magnitude (five bf16 unit roundoffs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import ffn as jffn
from repro_torch.configs import get_arch
from repro_torch.models import ffn as tffn

IMPLS = ("gshard", "sorted")
TOL = {"fp32": 1e-5, "bf16": 2e-2}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    t = torch.from_numpy(np.array(jnp.asarray(tree, jnp.float32)))
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t


def layer(arch, dtype, *, cf=None, impl="gshard", seed=0, zero_router=False):
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    moe = {"impl": impl} | ({"capacity_factor": cf} if cf else {})
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    jcfg = dataclasses.replace(jcfg,
                               moe=dataclasses.replace(jcfg.moe, **moe))
    jp = jffn.init_moe(jax.random.PRNGKey(seed), jcfg)
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    return cfg, jcfg, jp, to_torch(jp)


def tokens(cfg, seed, B=2, T=24, skew=0.0):
    """[B, T, D] fp32; ``skew`` adds one direction to every token, which
    moves every router logit alike and crowds a few experts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, cfg.d_model))
    x += skew * rng.normal(size=(cfg.d_model,))
    return x.astype(np.float32)


def run_both(cfg, jcfg, jp, tp, x, dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jy, jaux = jffn.moe_forward(jp, jnp.asarray(x, jdt), jcfg)
    ty, taux = tffn.moe_forward(tp, torch.from_numpy(x).to(tdt), cfg)
    return ty, taux, np.asarray(jnp.asarray(jy, jnp.float32)), float(jaux)


def assert_close(dtype, ty, taux, jy, jaux):
    assert ty.shape == jy.shape
    assert float(np.abs(ty.float().numpy() - jy).max()) <= \
        TOL[dtype] * float(np.abs(jy).max())
    assert abs(float(taux) - jaux) <= 1e-6 * max(1.0, abs(jaux))


def drops(cfg, tp, x) -> int:
    """Assignments past their expert's capacity, by the port's routing."""
    S = x.shape[0] * x.shape[1]
    xt = torch.from_numpy(x).to(tp["router"].dtype).reshape(S, -1)
    cap, _, _, experts = tffn._route(tp, xt, cfg)
    counts = torch.bincount(experts.reshape(-1), minlength=cfg.moe.n_experts)
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "deepseek-moe-16b"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_capacity_matches_jax(impl, arch, dtype):
    cfg, jcfg, jp, tp = layer(arch, dtype, impl=impl)
    x = tokens(cfg, 1)
    assert drops(cfg, tp, x) == 0
    assert_close(dtype, *run_both(cfg, jcfg, jp, tp, x, dtype))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "deepseek-moe-16b"])
def test_production_capacity_drops_like_jax(impl, arch):
    cfg, jcfg, jp, tp = layer(arch, "fp32", cf=1.25, impl=impl, seed=2)
    x = tokens(cfg, 2, T=40, skew=3.0)
    assert drops(cfg, tp, x) > 0
    ty, taux, jy, jaux = run_both(cfg, jcfg, jp, tp, x, "fp32")
    assert_close("fp32", ty, taux, jy, jaux)
    full = layer(arch, "fp32", impl=impl, seed=2)
    ky, _, _, _ = run_both(*full, x, "fp32")
    assert float((ky - ty).abs().max()) > 1e-2  # the drops changed y


@pytest.mark.parametrize("impl", IMPLS)
def test_tied_probabilities_take_the_lower_experts(impl):
    cfg, jcfg, jp, tp = layer("jamba-1.5-large-398b", "fp32", impl=impl,
                              cf=1.25, zero_router=True)
    x = tokens(cfg, 3)
    S = x.shape[0] * x.shape[1]
    _, _, gates, experts = tffn._route(tp, torch.from_numpy(x).reshape(S, -1),
                                       cfg)
    assert experts.tolist() == [[0, 1]] * S
    assert torch.equal(gates, torch.full_like(gates, 0.5))
    assert_close("fp32", *run_both(cfg, jcfg, jp, tp, x, "fp32"))


def test_the_two_forms_agree_and_decode_never_drops():
    """One token at a time (decode) fits the capacity floor of K."""
    cfg, _, _, tp = layer("jamba-1.5-large-398b", "fp32", cf=1.25)
    x = torch.from_numpy(tokens(cfg, 4, B=1, T=1))
    sorted_cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="sorted"))
    y, aux = tffn.moe_forward(tp, x, cfg)
    ys, auxs = tffn.moe_forward(tp, x, sorted_cfg)
    assert float((y - ys).abs().max()) < 1e-6 and abs(float(aux - auxs)) < 1e-7
    assert drops(cfg, tp, x.numpy()) == 0 and float(y.abs().max()) > 0
