"""The arithmetic of the two recurrent scans' chunk-parallel designs
(``csrc/wkv6.cu`` and ``csrc/ssd.cu``), on the CPU: what the CUDA
kernels compute in another form, held to the plain versions they are
compared with on the card.

Both prefills run in three phases over chunks of ``CHUNK`` = 64 steps:

* (a) each chunk's state increment and decay, every chunk at once;
* (b) a short sequential pass over the chunks that forms the state
  entering each chunk and the final state;
* (c) each chunk's outputs at once: the entering state's term plus the
  intra-chunk term.

For ``wkv6`` the intra-chunk term keeps the exact pairwise exponent only
on diagonal sub-chunks of 16 steps; between sub-chunks it factors at the
later sub-chunk's start b, (r_t exp(cumx_t - cumx_b)) . (k_s exp(cumx_b -
cum_s)), both exponents 0 or less.  For ``ssd`` the decay is one scalar a
step and head; each pair (t, s <= t) takes one exponent, formed from
strip-local sums as for ``wkv6``.
Every exponent is a non-positive sum of log decays (in log2 units, as the
kernels take them), so nothing overflows at logw = -8 over a chunk of 64
(a summed decay of 512).

The fp32 emulation holds the algebra to ``wkv6_plain`` / ``ssd_plain``
at small shapes.  The bf16 emulation rounds each tensor-core operand as
the kernels do: operands that arrive in bf16 (r, k, v, x, B_, C_) go in
as they are, and an operand computed in fp32 (a decay-weighted r or k,
the G = (C B^T) * L * dt matrix, the intra-chunk scores, the state) goes
in as a bf16 pair hi = bf16(a), lo = bf16(a - hi): two products where
one side is a pair, three (hi.hi + hi.lo + lo.hi) where both are.  At
RWKV6-7B's prefill shape (T = 512, dh = 64) and Jamba's (T = 4096, dh =
64, N = 16), fewer heads, that holds chip_smoke.py's limits: outputs
elementwise within ATTN_STEPS bf16 unit roundoffs of the plain value
plus as many of 2^-8 of the largest, the final state within 2e-5 of its
largest magnitude.  Rounding each fp32 operand once to bf16 instead
breaks the output limit for both scans and the state limit for both
(``test_*_single_rounding_breaks_the_limits``), which is why the kernels
carry the pairs.

Inputs are drawn with numpy from a seed.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as kssd
from repro_torch.kernels import rwkv6_scan as kwkv

CHUNK = 64  # steps a block of the prefill kernels takes
SUB = 16  # wkv6: the diagonal sub-chunks with exact pairwise exponents
ATTN_STEPS = 4  # chip_smoke.py's limit for the bf16 kernels
STATE_TOL = 2e-5
LOG2E = 1.4426950408889634
CSRC = pathlib.Path(kwkv.kernel.__file__).parents[2] / "csrc"


def normal(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def bf16(a):
    return a.to(torch.bfloat16).float()


def pair(a, mode):
    """The operand as the tensor cores see it: (hi, lo) with lo None
    when one product takes it."""
    if mode == "fp32":
        return a, None
    hi = bf16(a)
    return hi, (bf16(a - hi) if mode == "split" else None)


def mm(a, b, mode, a_exact=False, b_exact=False):
    """a @ b with each side rounded as ``pair`` says, unless it arrived
    in bf16 (exact): hi.hi + hi.lo + lo.hi."""
    ah, al = (a, None) if a_exact else pair(a, mode)
    bh, bl = (b, None) if b_exact else pair(b, mode)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def pad_chunks(t, T, C):
    """[B, T, ...] -> [B, NC, C, ...], rows past T zero."""
    nc = -(-T // C)
    if nc * C != T:
        t = torch.cat([t, t.new_zeros((t.shape[0], nc * C - T)
                                      + tuple(t.shape[2:]))], 1)
    return t.reshape((t.shape[0], nc, C) + tuple(t.shape[2:]))


def state_pass(inc, decay, state):
    """(b): inc [B, H, NC, a, b], decay broadcastable to it; returns the
    state entering each chunk and the final state."""
    run = state.clone()
    entering = torch.empty_like(inc)
    for c in range(inc.shape[2]):
        entering[:, :, c] = run
        run = decay[:, :, c] * run + inc[:, :, c]
    return entering, run


def emulate_wkv6(r, k, v, logw, u, state=None, mode="split"):
    """csrc/wkv6.cu's bf16 prefill in three phases; mode "fp32" keeps
    every operand in fp32, "split" rounds as the kernel does, "once"
    rounds each fp32 operand once to bf16."""
    B, T, H, dh = r.shape
    C, NS = CHUNK, CHUNK // SUB
    exact = mode != "fp32"  # r, k, v arrive in bf16
    # [B, H, NC, NS, SUB, dh]
    rf, kf, vf, w = (pad_chunks(t.float(), T, C).permute(0, 3, 1, 2, 4)
                     .reshape(B, H, -1, NS, SUB, dh)
                     for t in (r, k, v, logw * LOG2E))
    # sums of log decays, each formed from its own terms (never as a
    # difference of two longer sums), as the kernel forms them
    L = w.cumsum(4)  # inclusive, inside each sub-chunk
    Lx = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], 4)
    Rx = torch.cat([w[..., 1:, :].flip(4).cumsum(4).flip(4),
                    torch.zeros_like(w[..., :1, :])], 4)  # the rest of it
    tot = L[..., -1:, :]  # [B, H, NC, NS, 1, dh]

    def span(lo, hi):  # the sub-chunks lo .. hi - 1
        out = torch.zeros_like(tot[:, :, :, 0])
        for i in range(lo, hi):
            out = out + tot[:, :, :, i]
        return out

    pre = torch.stack([span(0, i) for i in range(NS)], 3)
    post = torch.stack([span(i + 1, NS) for i in range(NS)], 3)
    total = span(0, NS)[..., 0, :]  # [B, H, NC, dh]

    # (a) dS = K~^T V, K~ = k exp2(total - cum_s)
    kt = (kf * torch.exp2(Rx + post)).flatten(3, 4)
    vv = vf.flatten(3, 4)
    inc = mm(kt.transpose(-1, -2), vv, mode, b_exact=exact)
    # (b)
    s0 = (torch.zeros(B, H, dh, dh) if state is None else state.float())
    entering, final = state_pass(inc, torch.exp2(total)[..., None], s0)
    # (c) the entering state's term
    rt = (rf * torch.exp2(pre + Lx)).flatten(3, 4)
    out = mm(rt, entering, mode)
    # the intra-chunk scores A [.., C, C]
    att = torch.zeros(B, H, rf.shape[2], C, C)
    uu = u.float()[None, :, None, None, :]
    for j in range(NS):
        rows = slice(j * SUB, (j + 1) * SUB)
        # diagonal: exact pairwise exponents, the bonus on s = t
        e = Lx[:, :, :, j, :, None, :] - L[:, :, :, j, None, :, :]
        diag = (rf[:, :, :, j, :, None, :] * kf[:, :, :, j, None, :, :]
                * torch.exp2(torch.clamp(e, max=0.0))).sum(-1)
        diag = diag.tril(-1) + torch.diag_embed(
            (rf[:, :, :, j] * uu * kf[:, :, :, j]).sum(-1))
        att[..., rows, rows] = diag
        if j == 0:
            continue
        # below the diagonal: factored at the sub-chunk's start b
        rh = rf[:, :, :, j] * torch.exp2(Lx[:, :, :, j])
        between = torch.stack([span(i + 1, j) for i in range(j)], 3)
        kh = (kf[:, :, :, :j] * torch.exp2(Rx[:, :, :, :j] + between)) \
            .flatten(3, 4)
        att[..., rows, :j * SUB] = mm(rh, kh.transpose(-1, -2), mode)
    out = out + mm(att, vv, mode, b_exact=exact)
    o = out.reshape(B, H, -1, dh)[:, :, :T].permute(0, 2, 1, 3)
    return o.to(r.dtype), final


def emulate_ssd(x, dt, B_, C_, A, state=None, mode="split"):
    """csrc/ssd.cu's bf16 prefill in three phases (modes as for
    ``emulate_wkv6``).  The log decay a_t = dt_t A is one scalar a step
    and head; its sums are formed per strip of ``SUB`` rows as for
    ``wkv6``, and each pair (t, s <= t) takes one exponent: inside a
    strip the difference of two strip-local sums, below it the sum of
    t's strip prefix, s's strip suffix and the strips between."""
    Bsz, T, H, dh = x.shape
    C, NS = CHUNK, CHUNK // SUB
    exact = mode != "fp32"  # x, B_, C_ arrive in bf16
    xf = pad_chunks(x.float(), T, C).permute(0, 3, 1, 2, 4)
    dtf = pad_chunks(dt.float(), T, C).permute(0, 3, 1, 2)
    bm = pad_chunks(B_.float(), T, C)[:, None]  # [B, 1, NC, C, N]
    cm = pad_chunks(C_.float(), T, C)[:, None]
    a = (dtf * (A.float() * LOG2E)[None, :, None, None]) \
        .reshape(Bsz, H, -1, NS, SUB)
    L = a.cumsum(-1)  # inclusive, inside each strip
    Rx = torch.cat([a[..., 1:].flip(-1).cumsum(-1).flip(-1),
                    torch.zeros_like(a[..., :1])], -1)
    tot = L[..., -1]  # [B, H, NC, NS]

    def span(lo, hi):
        out = torch.zeros_like(tot[..., 0])
        for i in range(lo, hi):
            out = out + tot[..., i]
        return out

    pre = torch.stack([span(0, i) for i in range(NS)], -1)[..., None]
    post = torch.stack([span(i + 1, NS) for i in range(NS)], -1)[..., None]
    total = span(0, NS)
    # (a) dS = X^T (B_ exp2(total - cum_s) dt_s)
    wt = (torch.exp2(Rx + post).flatten(-2) * dtf)[..., None]
    inc = mm(xf.transpose(-1, -2), bm * wt, mode, a_exact=exact)
    # (b)
    N = B_.shape[-1]
    s0 = (torch.zeros(Bsz, H, dh, N) if state is None else state.float())
    entering, final = state_pass(inc, torch.exp2(total)[..., None, None],
                                 s0)
    # (c) exp2(cum_t) C_t S^T + ((C B^T) * L * dt_s) X
    out = torch.exp2(pre + L).flatten(-2)[..., None] * mm(
        cm, entering.transpose(-1, -2), mode, a_exact=exact)
    e = torch.full((Bsz, H, dtf.shape[2], C, C), float("-inf"))
    for j in range(NS):
        rows = slice(j * SUB, (j + 1) * SUB)
        diag = L[..., j, :, None] - L[..., j, None, :]
        e[..., rows, rows] = diag.masked_fill(
            ~torch.ones(SUB, SUB, dtype=torch.bool).tril(), float("-inf"))
        for i in range(j):
            e[..., rows, i * SUB:(i + 1) * SUB] = (
                L[..., j, :, None] + Rx[..., i, None, :]
                + span(i + 1, j)[..., None, None])
    cb = cm @ bm.transpose(-1, -2)  # bf16 products, fp32 sums
    g = cb * torch.exp2(e) * dtf[..., None, :]
    out = out + mm(g, xf, mode, b_exact=exact)
    y = out.reshape(Bsz, H, -1, dh)[:, :, :T].permute(0, 2, 1, 3)
    return y.to(x.dtype), final


def wkv_draw(rng, B, T, H, dh, dtype=torch.float32, lo=0.001, hi=0.15,
             carried=True):
    r, k, v = (normal(rng, (B, T, H, dh), dtype) for _ in range(3))
    logw = -torch.from_numpy(rng.uniform(lo, hi, size=(B, T, H, dh))
                             .astype(np.float32))
    u = normal(rng, (H, dh))
    state = normal(rng, (B, H, dh, dh)) if carried else None
    return r, k, v, logw, u, state


def ssd_draw(rng, B, T, H, dh, N, dtype=torch.float32, carried=True):
    x = normal(rng, (B, T, H, dh), dtype)
    Bm, Cm = (normal(rng, (B, T, N), dtype) for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.001, 0.4, size=(B, T, H))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.3, 1.5, size=(H,))
                          .astype(np.float32))
    state = normal(rng, (B, H, dh, N)) if carried else None
    return x, dt, Bm, Cm, A, state


def within(got, want, tol):
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) <= tol * scale


def attn_limit(plain):
    p = plain.float().abs()
    return ATTN_STEPS * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())


def test_chunk_lengths_are_the_kernels():
    """The emulations take the chunk lengths the CUDA sources build (in
    the headers each prefill shares with its backward)."""
    for name in ("wkv6", "ssd"):
        assert f'#include "{name}_chunk.cuh"' in (CSRC / f"{name}.cu") \
            .read_text(), name
        src = (CSRC / f"{name}_chunk.cuh").read_text()
        got = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
        assert got == CHUNK, name
    src = (CSRC / "wkv6_chunk.cuh").read_text()
    assert int(re.search(r"constexpr int kSub = (\d+);", src).group(1)) \
        == SUB


@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 129])
@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strong"])
def test_wkv6_three_phases_match_plain(T, strong):
    """fp32: the phases equal the step-by-step recurrence from a carried
    state, with decays down to logw = -8 (no inf or nan anywhere)."""
    rng = np.random.default_rng(T + 7 * strong)
    lo, hi = (0.5, 8.0) if strong else (0.001, 0.15)
    r, k, v, logw, u, state = wkv_draw(rng, 2, T, 3, 32, lo=lo, hi=hi)
    o, s = emulate_wkv6(r, k, v, logw, u, state, mode="fp32")
    po, ps = kwkv.wkv6_plain(r, k, v, logw, u, state)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert within(o, po, 1e-5) and within(s, ps, 1e-5)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 129])
def test_ssd_three_phases_match_plain(T):
    rng = np.random.default_rng(T + 100)
    x, dt, Bm, Cm, A, state = ssd_draw(rng, 2, T, 3, 32, 8)
    y, s = emulate_ssd(x, dt, Bm, Cm, A, state, mode="fp32")
    py, ps = kssd.ssd_plain(x, dt, Bm, Cm, A, state)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert within(y, py, 1e-5) and within(s, ps, 1e-5)


def test_ssd_three_phases_from_a_zero_state_with_strong_decay():
    """dt up to 20 at A = -1.5: summed decays of hundreds a chunk."""
    rng = np.random.default_rng(9)
    x, dt, Bm, Cm, A, _ = ssd_draw(rng, 1, 200, 2, 32, 16)
    dt = dt * 50
    y, s = emulate_ssd(x, dt, Bm, Cm, A, None, mode="fp32")
    py, ps = kssd.ssd_plain(x, dt, Bm, Cm, A)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert within(y, py, 1e-5) and within(s, ps, 1e-5)


def wkv6_checks(mode):
    """RWKV6-7B's prefill (T = 512, dh = 64) at 8 heads, decays down to
    logw = -8 as chip_smoke.py draws them, and a carried state: (outputs
    within ATTN_STEPS, final state within 2e-5)."""
    rng = np.random.default_rng(512)
    r, k, v = (normal(rng, (1, 512, 8, 64), torch.bfloat16)
               for _ in range(3))
    lo, hi = np.log(1e-3), np.log(8.0)
    logw = -torch.from_numpy(np.exp(rng.uniform(lo, hi, (1, 512, 8, 64)))
                             .astype(np.float32))
    u = normal(rng, (8, 64))
    state = normal(rng, (1, 8, 64, 64))
    o, s = emulate_wkv6(r, k, v, logw, u, state, mode=mode)
    po, ps = kwkv.wkv6_plain(r, k, v, logw, u, state)
    out_ok = bool(((o.float() - po.float()).abs() <= attn_limit(po)).all())
    return out_ok, within(s, ps, STATE_TOL)


def ssd_checks(mode):
    """Jamba's prefill (T = 4096, dh = 64, N = 16) at 4 heads and a
    carried state."""
    rng = np.random.default_rng(4096)
    x, dt, Bm, Cm, A, state = ssd_draw(rng, 1, 4096, 4, 64, 16,
                                       torch.bfloat16)
    y, s = emulate_ssd(x, dt, Bm, Cm, A, state, mode=mode)
    py, ps = kssd.ssd_plain(x, dt, Bm, Cm, A, state)
    out_ok = bool(((y.float() - py.float()).abs() <= attn_limit(py)).all())
    return out_ok, within(s, ps, STATE_TOL)


def test_wkv6_bf16_pairs_hold_chip_smoke_limits():
    assert wkv6_checks("split") == (True, True)


def test_ssd_bf16_pairs_hold_chip_smoke_limits():
    assert ssd_checks("split") == (True, True)


def test_wkv6_single_rounding_breaks_the_limits():
    out_ok, state_ok = wkv6_checks("once")
    assert not out_ok and not state_ok


def test_ssd_single_rounding_breaks_the_limits():
    out_ok, state_ok = ssd_checks("once")
    assert not out_ok and not state_ok
