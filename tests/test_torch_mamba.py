"""The port's Mamba mixer (repro_torch, on the CPU) against the JAX
package's ``repro.models.mamba``.

The JAX package's ``init_mamba`` draws the mixer of
jamba-1.5-large-398b's reduced configuration (d_model 128, d_in 256, 8
heads of 32, d_state 8, d_conv 4, chunk 16) from ``PRNGKey``; the same
arrays go into the port's functions, with inputs drawn with numpy from
a seed, over a ragged T (37 tokens, not a multiple of the chunk) and
five decode steps from the carried state.  Tolerances:

* fp32-cast parameters: every output and state within 1e-4 of its
  largest magnitude (the same arithmetic in another order: the port's
  scan runs the step-by-step recurrence, the JAX model its chunked jnp
  form);
* the bf16 parameters as ``init_mamba`` makes them: within 2e-2 of the
  largest magnitude, five bf16 unit roundoffs (2^-8).  The JAX model
  rounds its in-chunk scan terms to bf16 at other points than the port,
  which keeps the scan in fp32 and rounds once; over three seeds the two
  differ by up to 1.4%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import mamba as jmamba
from repro_torch.configs import get_arch
from repro_torch.models import mamba as tmamba

ARCH = "jamba-1.5-large-398b"
TOL = {"fp32": 1e-4, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t.to(dtype or TDT["bf16" if a.dtype == jnp.bfloat16 else "fp32"])


def mixer(dtype, seed=0):
    cfg, jcfg = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), jcfg)
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return cfg, jcfg, jp, {k: to_torch(v) for k, v in jp.items()}


def close(dtype, t, j):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    e = float(np.abs(t.float().numpy() - j).max())
    return e <= TOL[dtype] * float(np.abs(j).max())


def test_params_match_init_mamba():
    """Names, shapes and dtypes of the port's draw equal the JAX
    package's, and Jamba's full-width mixer holds 407,438,080."""
    cfg, _, jp, tp = mixer("bf16")
    own = tmamba.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert sorted(own) == sorted(tp)
    for name, t in own.items():
        assert t.shape == tp[name].shape and t.dtype == tp[name].dtype, name
    m = get_arch(ARCH).mamba
    d = get_arch(ARCH).d_model
    d_in, H = m.expand * d, m.expand * d // m.head_dim
    assert (d_in, H, m.head_dim, m.d_state) == (16384, 256, 64, 16)
    n = d * 2 * d_in + m.d_conv * d_in + d_in * 2 * m.d_state + d_in * H \
        + 3 * H + d_in * d
    assert n == 407_438_080


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_state_and_decode_match_jax(dtype):
    cfg, jcfg, jp, tp = mixer(dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37 + 5, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    jo, js = jmamba.mamba_forward(jp, jx[:, :37], jcfg, return_state=True)
    to, ts = tmamba.mamba_forward(tp, tx[:, :37], cfg, return_state=True)
    assert to.dtype == TDT[dtype] and close(dtype, to, jo)
    assert ts["ssm"].dtype == torch.float32 and ts["ssm"].shape == \
        js["ssm"].shape == (2, 8, 32, 8)
    assert ts["conv"].shape == js["conv"].shape == (2, 3, 256)
    for name in ("ssm", "conv"):
        assert close(dtype, ts[name], js[name]), name
    # a state of the cache dtype, as init_caches makes it
    js = {"ssm": js["ssm"], "conv": js["conv"].astype(jnp.bfloat16)}
    ts = {"ssm": ts["ssm"], "conv": ts["conv"].to(torch.bfloat16)}
    for t in range(37, 42):
        jo, js = jmamba.mamba_decode(jp, jx[:, t:t + 1], js, jcfg)
        to, ts = tmamba.mamba_decode(tp, tx[:, t:t + 1], ts, cfg)
        assert to.shape == (2, 1, cfg.d_model) and close(dtype, to, jo), t
        assert ts["conv"].dtype == torch.bfloat16
        for name in ("ssm", "conv"):
            assert close(dtype, ts[name], js[name]), (t, name)


@pytest.mark.parametrize("T", [1, 2, 16])
def test_short_prompts_and_zero_state(T):
    """Prompts shorter than the conv (its tail zero-padded), and a
    prefill equal to decode steps from ``init_mamba_state``."""
    cfg, jcfg, jp, tp = mixer("fp32", seed=T)
    x = np.random.default_rng(T).normal(
        size=(1, T, cfg.d_model)).astype(np.float32)
    jo, js = jmamba.mamba_forward(jp, jnp.asarray(x), jcfg,
                                  return_state=True)
    to, ts = tmamba.mamba_forward(tp, torch.from_numpy(x), cfg,
                                  return_state=True)
    assert close("fp32", to, jo)
    assert close("fp32", ts["conv"], js["conv"])
    state = tmamba.init_mamba_state(cfg, 1, torch.float32)
    steps = []
    for t in range(T):
        o, state = tmamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                       state, cfg)
        steps.append(o)
    assert close("fp32", torch.cat(steps, 1), jo)
    assert close("fp32", state["ssm"], js["ssm"])
