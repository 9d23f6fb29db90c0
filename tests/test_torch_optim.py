"""The port's optimizer, schedules and elasticity policies
(repro_torch, CPU) against the JAX package's, on the same numpy leaves.

Tolerances: fp32 values within 1e-6 of the largest magnitude of their
leaf (the same fp32 arithmetic, a few operations fused or ordered
otherwise); bf16 parameters, each the fp32 master rounded once, within
one bf16 unit in the last place of the JAX value.  The schedules are
computed in fp32 on both sides: within 1e-6 of the peak rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import elastic as jelastic
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.launch import elastic as telastic
from repro_torch.optim import AdamWState, adamw, schedules

FP32_TOL = 1e-6


def leaves(seed, bf16):
    """A small parameter dict and its gradients as numpy fp32 arrays;
    the ``w*`` leaves are bf16 when ``bf16`` (as the model's weights)."""
    rng = np.random.default_rng(seed)
    shapes = {"w_a": (16, 8), "w_b": (33,), "norm": (8,), "embed": (5, 7)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
    dtypes = {k: ("bf16" if bf16 and k.startswith("w") else "fp32")
              for k in shapes}
    return params, grads, dtypes


def as_jax(tree, dtypes):
    return {k: jnp.asarray(a, jnp.bfloat16 if dtypes[k] == "bf16"
                           else jnp.float32) for k, a in tree.items()}


def as_torch(tree, dtypes):
    return {k: torch.from_numpy(a.copy()).to(
        torch.bfloat16 if dtypes[k] == "bf16" else torch.float32)
        for k, a in tree.items()}


def close(t, j, tol=FP32_TOL):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.float().numpy() - j).max()) <= \
        tol * max(float(np.abs(j).max()), 1e-30)


def within_bf16_ulp(t, j):
    """Each element within one bf16 ulp of the JAX value."""
    j = np.asarray(j, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(j), 1e-30))) - 7)
    return bool((np.abs(t.float().numpy() - j) <= ulp).all())


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_init_matches_jax(bf16):
    params, _, dtypes = leaves(0, bf16)
    js = jadamw.init(as_jax(params, dtypes))
    ts = adamw.init(as_torch(params, dtypes))
    assert isinstance(ts, AdamWState) and ts.step == int(js.step) == 0
    for k in params:
        for part in ("m", "v", "master"):
            t, j = getattr(ts, part)[k], getattr(js, part)[k]
            assert t.dtype == torch.float32 and t.shape == j.shape
            assert np.array_equal(t.numpy(), np.asarray(j)), (k, part)


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["unclipped", "clipped"])
def test_global_norm_matches_jax(scale):
    _, grads, dtypes = leaves(1, True)
    grads = {k: g * scale for k, g in grads.items()}
    t = adamw.global_norm(as_torch(grads, dtypes))
    j = jadamw.global_norm(as_jax(grads, dtypes))
    assert t.dtype == torch.float32
    assert close(t, j)


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gscale", [0.05, 3.0], ids=["small", "large"])
def test_update_matches_jax_over_steps(bf16, clip, gscale):
    """Four updates from the same params with the same gradients each
    step, at the WSD rate of each step: moments, master and params
    follow the JAX update."""
    params, _, dtypes = leaves(2, bf16)
    jp, tp = as_jax(params, dtypes), as_torch(params, dtypes)
    js, ts = jadamw.init(jp), adamw.init(tp)
    rng = np.random.default_rng(3)
    for i in range(4):
        grads = {k: (rng.normal(size=a.shape) * gscale).astype(np.float32)
                 for k, a in params.items()}
        lr_j = jsched.for_arch("minicpm-2b", js.step + 1, total=100)
        lr_t = schedules.for_arch("minicpm-2b", ts.step + 1, total=100)
        jp, js = jadamw.update(as_jax(grads, dtypes), js, jp, lr=lr_j,
                               clip_norm=clip)
        tp_out, ts = adamw.update(as_torch(grads, dtypes), ts, tp,
                                  lr=lr_t, clip_norm=clip)
        assert ts.step == int(js.step) == i + 1
        for k in params:
            assert tp_out[k] is tp[k]  # updated in place
            assert tp[k].dtype == (torch.bfloat16 if dtypes[k] == "bf16"
                                   else torch.float32)
            for part in ("m", "v", "master"):
                assert close(getattr(ts, part)[k], getattr(js, part)[k]), \
                    (i, k, part)
            if dtypes[k] == "bf16":
                assert within_bf16_ulp(tp[k], jp[k]), (i, k)
            else:
                assert close(tp[k], jp[k]), (i, k)


@pytest.mark.parametrize("total", [100, 1000, 10000])
@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-0.5b"])
def test_for_arch_matches_jax(arch, total):
    steps = sorted({0, 1, 2, total // 200, total // 100, total // 100 + 1,
                    total // 2, int(total * 0.91), int(total * 0.95),
                    total - 1, total, total + 5})
    for s in steps:
        t = schedules.for_arch(arch, s, total=total)
        j = jsched.for_arch(arch, s, total=total)
        assert t.dtype == torch.float32
        assert abs(float(t) - float(j)) <= FP32_TOL * 3e-4, (arch, s)


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup=10, stable=50, decay=40),
    dict(peak_lr=3e-4, warmup=0, stable=5, decay=0, final_frac=0.3),
])
def test_wsd_matches_jax(kw):
    for s in range(0, 120, 3):
        assert abs(float(schedules.wsd(s, **kw))
                   - float(jsched.wsd(s, **kw))) <= FP32_TOL * kw["peak_lr"]


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup=10, total=100),
    dict(peak_lr=2e-4, warmup=0, total=1, final_frac=0.0),
])
def test_cosine_matches_jax(kw):
    for s in range(0, 120, 3):
        assert abs(float(schedules.cosine(s, **kw))
                   - float(jsched.cosine(s, **kw))) <= \
            FP32_TOL * kw["peak_lr"]


# ----------------------------------------------------------------------
# elasticity: the JAX tests' cases on both packages
# ----------------------------------------------------------------------
def fleet_run(mod):
    m = mod.FleetMonitor(4, timeout_steps=2, straggler_factor=2.0,
                         straggler_patience=2)
    sweeps = []
    for step in range(6):
        for w in range(4):
            if w == 3 and step >= 2:
                continue  # worker 3 dies at step 2
            t = 1.0 if w != 2 else 3.5  # worker 2 is slow
            m.heartbeat(w, step, t)
        sweeps.append(m.sweep())
    return sweeps, m


def test_fleet_monitor_matches_jax():
    t_sweeps, tm = fleet_run(telastic)
    j_sweeps, jm = fleet_run(jelastic)
    assert t_sweeps == j_sweeps
    dead, strag = t_sweeps[-1]
    assert 3 in dead and 2 in strag
    assert {w: vars(s) for w, s in tm.workers.items()} == \
        {w: vars(s) for w, s in jm.workers.items()}
    tm.kill(1)
    assert 1 in tm.sweep()[0]


@pytest.mark.parametrize("n_alive,model,pod", [(256, 16, 1), (240, 16, 1),
                                               (15, 16, 1), (64, 8, 2),
                                               (7, 4, 2), (1, 1, 1)])
def test_elastic_mesh_plan_matches_jax(n_alive, model, pod):
    assert telastic.elastic_mesh_plan(n_alive, model, pod) == \
        jelastic.elastic_mesh_plan(n_alive, model, pod)
    assert telastic.elastic_mesh_plan(256, 16) == (16, 16)
    assert telastic.elastic_mesh_plan(240, 16) == (15, 16)
    assert telastic.elastic_mesh_plan(15, 16) is None


@pytest.mark.parametrize("gb,dp,pdb", [(256, 15, 1), (256, 16, 1),
                                       (8, 3, 4), (1, 4, 2)])
def test_accumulation_for_matches_jax(gb, dp, pdb):
    assert telastic.accumulation_for(gb, dp, pdb) == \
        jelastic.accumulation_for(gb, dp, pdb)
    assert telastic.accumulation_for(256, 15, 1) == 18
