"""Rematerialized training on the port (``LM(..., remat=...)``,
``device="cpu"``, fp32) against the port without it and against the
JAX package's ``LM(cfg, remat=policy)``.

* Under ``"full"`` and ``"dots"`` the loss and every parameter's
  gradient equal ``"none"``'s bit for bit: a region recomputes the same
  fp32 arithmetic in the same order.
* Under ``"dots"`` and ``"none"`` they match the JAX package's
  ``value_and_grad`` of the same policy on the same weights
  (``convert.lm_params_from_arrays``) within the training tolerances
  (``PERF.md`` §2): the loss within 1e-5 of its value, each gradient
  within 1e-4 of that leaf's largest magnitude.  ``"full"``, both
  packages' default, is ``tests/test_torch_train.py``'s comparison.
* The regions are the JAX package's ``_run_groups`` regions: one a
  block of a group that runs once, one a pattern period of a repeated
  group (derived here from the JAX model's ``plan``), counted as the
  checkpointed calls of one forward; Whisper's encoder runs in none.
* Under grad off (and under ``"none"``) no region runs.

Families: dense (CodeQwen1.5-7B), MoE (DeepSeek-MoE with its ``dense0``
group), RWKV6, the Jamba hybrid and Whisper-tiny, each ``reduced()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.model import LM as JLM
from repro.models.model import REMAT_POLICIES as JAX_POLICIES
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import model as model_mod
from repro_torch.models.model import LM, REMAT_POLICIES, remat_regions

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# (arch, T): each T ragged over the JAX scans' chunk of 16
ARCHS = {"dense": ("codeqwen1.5-7b", 24), "moe": ("deepseek-moe-16b", 20),
         "rwkv6": ("rwkv6-7b", 37), "hybrid": ("jamba-1.5-large-398b", 17),
         "whisper": ("whisper-tiny", 20)}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(arch, **over):
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    return cfg, jcfg


def draw_batch(cfg, T, B=2, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = rng.normal(size=(
            B, cfg.encdec.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def fp32_lm(cfg, remat, params=None):
    """The port's ``LM`` in fp32 under ``remat``: the JAX package's
    weights where given, else its own from seed 0."""
    lm = LM(cfg, device="cpu", remat=remat)
    if params is None:
        for p in lm.parameters():
            p.data = p.data.float()
    else:
        lm.load_state_dict(lm_params_from_arrays(params, cfg), assign=True)
    lm.requires_grad_(True)
    return lm


def loss_and_grads(lm, batch):
    loss = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in lm.named_parameters()}


def rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max()) / max(
        float(np.abs(j).max()), 1e-30)


@pytest.fixture
def regions_run(monkeypatch):
    """The [start, stop) layers of each region ``checkpoint`` runs."""
    seen = []
    real = model_mod.checkpoint

    def counting(fn, *args, **kwargs):
        seen.append(fn.args)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", counting)
    return seen


def test_policies_are_the_jax_packages():
    assert set(REMAT_POLICIES) == set(JAX_POLICIES)
    cfg, _ = configs("codeqwen1.5-7b")
    with pytest.raises(ValueError, match="remat="):
        LM(cfg, device="meta", remat="offload")
    assert LM(cfg, device="meta").remat == "full"


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_policy_equals_none_bit_for_bit(family, policy):
    arch, T = ARCHS[family]
    cfg, _ = configs(arch)
    batch = draw_batch(cfg, T)
    want_loss, want = loss_and_grads(fp32_lm(cfg, "none"), batch)
    loss, got = loss_and_grads(fp32_lm(cfg, policy), batch)
    assert torch.equal(loss, want_loss)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g is not None and torch.equal(g, want[name]), name


@pytest.mark.parametrize("policy", ["dots", "none"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_policy_matches_jax(family, policy):
    arch, T = ARCHS[family]
    cfg, jcfg = configs(arch)
    jm = JLM(jcfg, remat=policy)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    batch = draw_batch(cfg, T)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = loss_and_grads(fp32_lm(cfg, policy, to_np(jp)), batch)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = lm_params_from_arrays(to_np(jgrads), cfg)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert rel(g, want[name].numpy()) <= GRAD_TOL, name


def jax_regions(jcfg):
    """The layers of each region the JAX package's ``_run_groups``
    checkpoints: one a block where a group runs once, one a pattern
    period of a repeated group (a scan body)."""
    out, l0 = [], 0
    for _, pattern, repeat in JLM(jcfg).plan:
        step = len(pattern) if repeat > 1 else 1
        out += [(s, s + step)
                for s in range(l0, l0 + len(pattern) * repeat, step)]
        l0 += len(pattern) * repeat
    return out


@pytest.mark.parametrize("arch,over,n_regions,layers_each", [
    ("codeqwen1.5-7b", {}, 2, 1),
    ("codeqwen1.5-7b", {"n_layers": 5}, 5, 1),
    ("deepseek-moe-16b", {}, 2, 1),            # dense0, then one MoE layer
    ("deepseek-moe-16b", {"n_layers": 4}, 4, 1),  # dense0 + a scan of 3
    ("rwkv6-7b", {}, 2, 1),
    ("jamba-1.5-large-398b", {}, 8, 1),        # one superblock: runs once
    ("jamba-1.5-large-398b", {"n_layers": 16}, 2, 8),  # a scan of 2
    ("whisper-tiny", {}, 2, 1),                # the decoder's; no encoder
])
def test_regions_are_the_jax_run_groups(regions_run, arch, over, n_regions,
                                        layers_each):
    cfg, jcfg = configs(arch, **over)
    assert remat_regions(cfg) == jax_regions(jcfg)
    assert len(remat_regions(cfg)) == n_regions
    assert {b - a for a, b in remat_regions(cfg)} == {layers_each}
    lm = fp32_lm(cfg, "full")
    batch = draw_batch(cfg, 9)
    lm.loss({k: torch.from_numpy(v) for k, v in batch.items()}).backward()
    assert regions_run == remat_regions(cfg)
    if cfg.encdec is not None:  # the encoder's blocks are not layers
        assert len(lm.encoder) > 0 and max(
            b for _, b in regions_run) == len(lm.layers)


@pytest.mark.parametrize("family", ["dense", "hybrid", "whisper"])
def test_no_region_under_grad_off_or_none(regions_run, family):
    arch, _ = ARCHS[family]
    cfg, _ = configs(arch)
    T = 9
    batch = {k: torch.from_numpy(v)
             for k, v in draw_batch(cfg, T).items()}
    lm = fp32_lm(cfg, "full")
    with torch.no_grad():
        lm.forward(batch)
    lm.prefill(batch, T)
    if cfg.encdec is None:
        lm.decode_step(torch.zeros(2, dtype=torch.int64),
                       lm.init_caches(2, 48),
                       torch.full((2,), T, dtype=torch.int64))
    none = fp32_lm(cfg, "none")
    none.loss(batch).backward()
    assert regions_run == []
    lm.loss(batch).backward()
    assert len(regions_run) == len(remat_regions(cfg))
