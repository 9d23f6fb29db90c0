"""The gradient of the port's attention (repro_torch, CPU tensors)
against the JAX package, and the guards of the kernels that have no
backward yet.

``attention_bwd_plain`` (the formulas the backward kernel
``csrc/flash_attention_bwd.cu`` computes) is held against ``jax.vjp``
of the JAX package's ``_sdpa`` with its ``causal_mask``, in fp32, on
inputs drawn with numpy from a seed: each gradient within 1e-5 of its
largest magnitude (the same fp32 arithmetic in another order).  ``mha``
is a ``torch.autograd.Function`` whose backward runs the backward
kernel's wrapper; ``torch.autograd.gradcheck`` holds it, in float64, to
finite differences of its forward.  The backward kernel reads the
forward's log-sum-exp: ``flash_attention_bwd`` rejects one of the wrong
shape, dtype or device (on the CPU too, where the plain version does
not read it), and ``mha`` asks the forward for it only when a gradient
can follow, so ``LM.prefill`` runs the forward without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.common import causal_mask
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mamba_scan as kssd
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.kernels import rwkv6_scan as kwkv

GRAD_TOL = 1e-5


def jax_grads(q, k, v, dout, causal, window):
    """dq, dk, dv of the JAX package's ``_sdpa`` (right-aligned causal
    mask, optional window) by ``jax.vjp``."""
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    mask = (causal_mask(T, S, window=window, q_offset=S - T) if causal
            else None)

    def f(a, b, c):
        return jattn._sdpa(a, b, c, mask, H // Hk).reshape(B, T, H, dh)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


CASES = [
    # B, T, S, H, Hk, dh, causal, window
    (2, 64, 64, 4, 4, 32, True, None),     # causal, one tile
    (1, 70, 70, 4, 2, 32, True, None),     # GQA, T not a multiple of 64
    (2, 100, 100, 6, 2, 32, True, 24),     # a window that masks keys
    (1, 37, 90, 4, 1, 64, True, None),     # T < S: right-aligned queries
    (1, 65, 130, 4, 2, 32, True, 40),      # T < S with a window
    (1, 50, 60, 2, 1, 32, False, None),    # bidirectional
    (1, 129, 129, 2, 2, 128, True, 100),
]


@pytest.mark.parametrize("B,T,S,H,Hk,dh,causal,window", CASES)
def test_attention_bwd_plain_matches_jax_vjp(B, T, S, H, Hk, dh, causal,
                                             window):
    rng = np.random.default_rng(T * 7 + S + dh)
    q = rng.normal(size=(B, T, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, dh)).astype(np.float32)
    dout = rng.normal(size=(B, T, H, dh)).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = kflash.attention_plain(tq, tk, tv, causal=causal, window=window)
    got = kflash.attention_bwd_plain(tq, tk, tv, out, tdo, causal=causal,
                                     window=window)
    want = jax_grads(q, k, v, dout, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * scale, name


@pytest.mark.parametrize("B,T,S,H,Hk,dh,causal,window", CASES[:4])
def test_mha_backward_is_the_wrapper_and_counts_no_launch(B, T, S, H, Hk, dh,
                                                          causal, window):
    """Autograd through ``mha`` on the CPU gives the backward wrapper's
    plain version exactly, and launches (counts) nothing."""
    rng = np.random.default_rng(T + S)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .requires_grad_() for shape in ((B, T, H, dh), (B, S, Hk, dh),
                                               (B, S, Hk, dh)))
    dout = torch.from_numpy(rng.normal(size=(B, T, H, dh))
                            .astype(np.float32))
    before = dict(kflash.LAUNCHES)
    out = kflash.mha(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = kflash.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                      out.detach(), dout, causal=causal,
                                      window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kflash.LAUNCHES == before


def test_mha_backward_takes_a_strided_gradient():
    """Autograd may hand the output's gradient over strided: the
    backward makes it contiguous for the kernel's wrapper."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 9, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 9, 1, 32)).astype(np.float32))
    v = k.clone()
    for t in (q, k, v):
        t.requires_grad_()
    out = kflash.mha(q, k, v)
    (out.transpose(1, 2) * 2.0).sum().backward()  # a strided gradient
    want = kflash.attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                      out.detach(),
                                      torch.full_like(out, 2.0))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("causal,window,T,S", [(True, None, 5, 5),
                                               (True, 3, 7, 7),
                                               (True, None, 6, 4),
                                               (False, None, 3, 5)])
def test_mha_gradcheck_float64(causal, window, T, S):
    """Finite differences of the forward in float64 (the plain versions
    compute in float64 for float64 inputs); with T > S two rows see no
    key and take a zero gradient."""
    gen = torch.Generator().manual_seed(T * 10 + S)
    q = torch.randn(2, T, 4, 8, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    k = torch.randn(2, S, 2, 8, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    v = torch.randn(2, S, 2, 8, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: kflash.mha(a, b, c, causal=causal, window=window),
        (q, k, v))


def test_flash_attention_bwd_checks_its_inputs():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="out is"):
        kflash.flash_attention_bwd(q, k, k, q[:, :3], q)
    with pytest.raises(TypeError, match="dout is"):
        kflash.flash_attention_bwd(q, k, k, q, q.double())
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention_bwd(q, k, k, q,
                                   q.transpose(1, 2).contiguous()
                                   .transpose(1, 2))


def _lse_args():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 4, 1, 32)
    return q, k, torch.zeros(1, 2, 4)


@pytest.mark.parametrize("lse,error,match", [
    (torch.zeros(1, 4, 2), ValueError, "not \\[B, H, T\\]"),     # [B, T, H]
    (torch.zeros(1, 2, 5), ValueError, "not \\[B, H, T\\]"),
    (torch.zeros(1, 2, 4, dtype=torch.bfloat16), TypeError, "lse is"),
    (torch.zeros(1, 2, 4, dtype=torch.float64), TypeError, "lse is"),
    (torch.zeros(1, 2, 4, device="meta"), ValueError, "lse is on"),
    (torch.zeros(1, 4, 2).transpose(1, 2), ValueError, "contiguous"),
], ids=["transposed-shape", "wrong-T", "bf16", "float64", "meta-device",
        "strided"])
def test_flash_attention_bwd_rejects_a_wrong_lse(lse, error, match):
    """The forward's LSE is fp32 [B, H, T] on q's device (float64 for
    float64 inputs, which only the CPU takes): anything else raises, on
    the CPU too, where the plain version does not read it."""
    q, k, good = _lse_args()
    with pytest.raises(error, match=match):
        kflash.flash_attention_bwd(q, k, k, q, q, lse=lse)
    got = kflash.flash_attention_bwd(q, k, k, q, q, lse=good)
    want = kflash.flash_attention_bwd(q, k, k, q, q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_flash_attention_bwd_takes_a_float64_lse_for_float64_inputs():
    q = torch.zeros(1, 4, 2, 32, dtype=torch.float64)
    k = torch.zeros(1, 4, 1, 32, dtype=torch.float64)
    kflash.flash_attention_bwd(q, k, k, q, q,
                               lse=torch.zeros(1, 2, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="lse is"):
        kflash.flash_attention_bwd(q, k, k, q, q, lse=torch.zeros(1, 2, 4))


@pytest.fixture
def lse_calls(monkeypatch):
    """Records the ``return_lse`` of each forward ``mha`` runs and the
    ``lse`` each backward receives."""
    from repro_torch.kernels.flash_attention import ops
    calls = {"forward": [], "backward": []}
    fwd, bwd = ops.flash_attention, ops.flash_attention_bwd

    def forward(*args, return_lse=False, **kw):
        calls["forward"].append(return_lse)
        return fwd(*args, return_lse=return_lse, **kw)

    def backward(*args, lse=None, **kw):
        calls["backward"].append(lse)
        return bwd(*args, lse=lse, **kw)

    monkeypatch.setattr(ops, "flash_attention", forward)
    monkeypatch.setattr(ops, "flash_attention_bwd", backward)
    return calls


def test_mha_saves_lse_under_grad_only(lse_calls):
    """Grad enabled with an input that requires it: the forward returns
    its LSE and the backward receives that very tensor.  Under
    ``no_grad``, or with no input requiring grad, the forward is asked
    for none."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    kflash.mha(q, k, v)  # nothing requires grad
    with torch.no_grad():
        kflash.mha(q.requires_grad_(), k, v, window=9)
    assert lse_calls["forward"] == [False, False]
    out = kflash.mha(q, k, v, window=9)
    assert lse_calls["forward"] == [False, False, True]
    out.square().sum().backward()
    (lse,) = lse_calls["backward"]
    _, want = kflash.attention_plain(q.detach(), k, v, window=9,
                                     return_lse=True)
    assert torch.equal(lse, want)


def test_lm_prefill_runs_the_forward_without_lse(lse_calls):
    """``LM.prefill`` (under ``no_grad``) leaves the forward's
    ``return_lse`` false; ``LM.loss`` on trainable parameters asks for it
    in every attention layer, twice under the default ``remat="full"``
    (the forward, and its recompute in the backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    cfg = get_arch("qwen2-0.5b").reduced()
    lm = LM(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 17)))
    lm.prefill({"tokens": toks[:, :-1]}, 16)
    assert lse_calls["forward"] == [False] * cfg.n_layers
    lm.requires_grad_(True)
    lm.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]}).backward()
    assert lm.remat == "full"
    assert lse_calls["forward"] == [False] * cfg.n_layers + \
        [True] * cfg.n_layers * 2
    assert len(lse_calls["backward"]) == cfg.n_layers
    assert all(t is not None for t in lse_calls["backward"])


# ----------------------------------------------------------------------
# the kernels with no backward refuse to run under grad
# ----------------------------------------------------------------------
def _wkv6_args(grad):
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 4, 2, 32, generator=gen) for _ in range(3))
    logw = -torch.rand(1, 4, 2, 32, generator=gen)
    u = torch.randn(2, 32, generator=gen)
    return (r.requires_grad_(grad), k, v, logw, u)


def _ssd_args(grad):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 2, 32, generator=gen)
    dt = torch.rand(1, 4, 2, generator=gen)
    B_, C_ = (torch.randn(1, 4, 8, generator=gen) for _ in range(2))
    A = -torch.rand(2, generator=gen) - 0.1
    return (x, dt.requires_grad_(grad), B_, C_, A)


def _paged_args(grad):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 32, generator=gen)
    pages = torch.randn(2, 16, 2, 32, generator=gen)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([20], dtype=torch.int32)
    return (q, pages.requires_grad_(grad), pages.clone(), table, lens)


@pytest.mark.parametrize("fn,args", [(kwkv.wkv6, _wkv6_args),
                                     (kssd.ssd, _ssd_args),
                                     (kpaged.paged_attention, _paged_args)],
                         ids=["wkv6", "ssd", "paged_attention"])
def test_kernels_without_backward_raise_under_grad(fn, args):
    """On the CPU the plain versions are differentiable, on the card a
    ctypes launch is not: under grad with an input that requires grad
    each wrapper raises on both devices (the guard runs before the
    device is looked at), and it runs under ``no_grad`` or without such
    an input."""
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        fn(*args(True))
    with torch.no_grad():
        fn(*args(True))
    fn(*args(False))
