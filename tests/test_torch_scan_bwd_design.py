"""The arithmetic of the two scans' chunk-parallel backward kernels
(``csrc/wkv6_bwd.cu`` and ``csrc/ssd_bwd.cu``, their bf16 form at
T > 1), on the CPU: what the CUDA kernels compute in another form, held
to the plain versions they are compared with on the card.

Both run over chunks of ``CHUNK`` = 64 steps and strips of ``SUB`` = 16:

* the states entering each chunk, from the prefill's phases (a)
  increments and (b) pass; the adjoints leaving each chunk, from the same
  two phases run on (r exp(cumx))^T do (WKV6) or dy^T (C_ exp(cum)) (SSD)
  and a reverse pass;
* each chunk's gradients at once.  Between strips every exponent factors
  at the strip boundary into two non-positive sums; on the diagonal
  16 x 16 tiles each pair keeps its exact exponent.

The decay's gradient comes from a chunk-local identity instead of the
per-step sum_v (G (x) S_{t-1}) of the serial walk:

* WKV6: dlogw_j = sum_{t>j} r_t dr'_t - sum_{s>=j} k_s dk'_s +
  sum_v (G_c (x) S_{c+1}), dr' and dk' without their u terms;
* SSD: dl_j = sum_{t>=j} dy_t . y_t - sum_{s>=j} x~_s . dx~_s +
  sum (G_c (x) S_{c+1}) (x~ = dt x), which the kernel takes in the form
  where the pairs (t, s) that appear in both sums are taken out:
  dl_j = sum_{t>=j} ia_t + sum_{s<j} ib_s + exp(total) <G_c, S_c> +
  sum_{t>=j>s} E_ts (the inter-chunk parts ia, ib and the crossing pairs
  E_ts = (dy_t . x~_s) (C_t . B_s) exp(cum_t - cum_s)).  The cancelling
  form misses ``FP32_TOL`` on dA with decays down to dt A = -12; this one
  holds it.

Both identities are checked alone in float64.  The fp32 emulation holds
the algebra to ``wkv6_bwd_plain`` / ``ssd_bwd_plain`` within 1e-5 of each
output's largest magnitude.  The bf16 emulation rounds each tensor-core
operand as the kernels do: operands that arrive in bf16 (r, k, v, do, x,
dy, B_, C_) go in as they are, the fp32 ones as bf16 pieces: three (hi +
mid + lo) where the products feed dlogw, ddt and dA (the states and
adjoints, the adjoint's increments, the intra-chunk tiles and the
decay-weighted k and r they meet), pairs for the states' increments
(the prefill's own, whose scratch the backward takes), dv and dB_.  At
RWKV6-7B's training shape and Jamba's mixer shape (fewer heads and batch
rows) that holds chip_smoke.py's limits (bf16 outputs elementwise within
``ATTN_STEPS`` bf16 unit roundoffs, fp32 outputs within ``FP32_TOL`` of
their largest magnitude), and dlogw, ddt and dA within half of
``FP32_TOL``: at RWKV6-7B's training shape dlogw reads 0.10 of the limit
(pairs there 0.28, one rounding 175 times it), at T = 512 of Jamba's
mixer shape ddt and dA 0.026 (pairs 0.11, one rounding 78 times).

Inputs are drawn with numpy from a seed.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as kssd
from repro_torch.kernels import rwkv6_scan as kwkv

CHUNK = 64
SUB = 16
NS = CHUNK // SUB
ATTN_STEPS = 4  # chip_smoke.py's limit for the bf16 outputs
FP32_TOL = 2e-5  # and for the fp32 ones, of the largest magnitude
LOG2E = 1.4426950408889634
CSRC = pathlib.Path(kwkv.kernel.__file__).parents[2] / "csrc"
# bf16 pieces of the fp32 operands: (the states' increments, the
# adjoint's increments, the states and adjoints in the inter-chunk
# products, the intra-chunk tiles, dv's and dB_'s); 0 keeps an operand in
# the emulation's dtype.  The states' increments are the prefill's, pairs
KERNEL = (2, 3, 3, 3, 2)
PAIRS = (2, 2, 2, 2, 2)
ONCE = (1, 1, 1, 1, 1)
EXACT = (0, 0, 0, 0, 0)


def bf16(a):
    return a.to(torch.bfloat16).to(a.dtype)


def pieces(a, n):
    if n == 0:
        return [a]
    out, rest = [], a
    for _ in range(n):
        p = bf16(rest)
        out.append(p)
        rest = rest - p
    return out


def mm(a, b, na, nb=0):
    """a @ b with each side in ``na`` / ``nb`` bf16 pieces (0: as it is),
    the products of pieces i, j with i + j < the larger count."""
    pa, pb = pieces(a, na), pieces(b, nb)
    top = max(len(pa), len(pb))
    out = 0
    for i, x in enumerate(pa):
        for j, y in enumerate(pb):
            if i + j < top:
                out = out + x @ y
    return out


def chunked(t, T):
    """[B, T, ...] -> [B, NC, CHUNK, ...], rows past T zero."""
    nc = -(-T // CHUNK)
    pad = nc * CHUNK - T
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.reshape((t.shape[0], nc, CHUNK) + t.shape[2:])


def span_table(tot):
    """tot [..., NS, *] -> span[lo][hi] = tot[lo] + ... + tot[hi - 1]."""
    zero = torch.zeros_like(tot[..., 0, :] if tot.dim() > 4 else
                            tot[..., 0])
    table = {}
    for lo in range(NS + 1):
        run = zero
        table[lo, lo] = run
        for hi in range(lo + 1, NS + 1):
            run = run + (tot[..., hi - 1, :] if tot.dim() > 4
                         else tot[..., hi - 1])
            table[lo, hi] = run
    return table


def reverse_pass(inc, decay, last):
    """G_{c-1} = decay_c G_c + inc_c from G_{NC-1} = last: the adjoint
    leaving each chunk and the input state's gradient."""
    out = [None] * inc.shape[2]
    G = last
    for c in reversed(range(inc.shape[2])):
        out[c] = G
        G = decay[:, :, c] * G + inc[:, :, c]
    return torch.stack(out, 2), G


def forward_pass(inc, decay, first):
    out, S = [], first
    for c in range(inc.shape[2]):
        out.append(S)
        S = decay[:, :, c] * S + inc[:, :, c]
    return torch.stack(out, 2), S


# ----------------------------------------------------------------------
# WKV6
# ----------------------------------------------------------------------

def emulate_wkv6_bwd(r, k, v, logw, u, do, state=None, dstate=None,
                     P=KERNEL, dtype=torch.float32):
    """csrc/wkv6_bwd.cu's bf16 form in ``dtype`` with operands in ``P``
    pieces; returns (dr, dk, dv, dlogw, du, dstate_in or None)."""
    B, T, H, dh = r.shape
    nc = -(-T // CHUNK)

    def ch(t):  # [B, H, NC, NS, SUB, dh]
        return chunked(t.to(dtype), T).reshape(B, nc, NS, SUB, H, dh) \
            .permute(0, 4, 1, 2, 3, 5)

    rf, kf, vf, df = ch(r), ch(k), ch(v), ch(do)
    w = ch(logw) * LOG2E
    cum = w.cumsum(4)  # strip-local inclusive
    cumx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                     4)
    tot = cum[..., -1, :]  # [B, H, NC, NS, dh]
    rest = tot[..., None, :] - cum  # the rest of the strip after the row
    sp = span_table(tot)
    pre = torch.stack([sp[0, i] for i in range(NS)], 3)
    post = torch.stack([sp[i + 1, NS] for i in range(NS)], 3)
    total = sp[0, NS]
    flat = lambda t: t.reshape(B, H, nc, CHUNK, dh)  # noqa: E731
    zeros = torch.zeros(B, H, dh, dh, dtype=dtype)
    # the states entering each chunk, the adjoints leaving it
    decay = torch.exp2(total)[..., None]
    kt = flat(kf * torch.exp2(rest + post[..., None, :]))
    inc = mm(kt.transpose(-1, -2), flat(vf), P[0])
    Sc, S_final = forward_pass(
        inc, decay, zeros if state is None else state.to(dtype))
    Sn = torch.cat([Sc[:, :, 1:], S_final[:, :, None]], 2)
    rt = flat(rf * torch.exp2(cumx + pre[..., None, :]))
    ginc = mm(rt.transpose(-1, -2), flat(df), P[1])
    Gc, dstate_in = reverse_pass(
        ginc, decay, zeros if dstate is None else dstate.to(dtype))
    # the chunks' gradients, strip by strip
    D = (flat(df) @ flat(vf).transpose(-1, -2)).reshape(
        B, H, nc, NS, SUB, NS, SUB)
    kw = kf * torch.exp2(rest)  # k weighted to its strip's end
    rw = rf * torch.exp2(cumx)  # r weighted from its strip's start
    drp, dkp, dv = (torch.zeros(B, H, nc, NS, SUB, dh, dtype=dtype)
                    for _ in range(3))
    below = torch.tril(torch.ones(SUB, SUB, dtype=dtype), -1)
    for a in range(NS):
        ex = cumx[:, :, :, a, :, None, :] - cum[:, :, :, a, None, :, :]
        E = torch.exp2(torch.where(below[..., None] > 0, ex,
                                   torch.full_like(ex, -torch.inf)))
        Dd = D[:, :, :, a, :, a] * below  # [t, s], s < t
        # dr': the entering state, the strips before, the diagonal tile
        acc = mm(df[:, :, :, a], (Sc * torch.exp2(pre[:, :, :, a])[
            ..., :, None]).transpose(-1, -2), 0, P[2])
        for j in range(a):
            acc = acc + mm(D[:, :, :, a, :, j],
                           kw[:, :, :, j] * torch.exp2(sp[j + 1, a])[
                               ..., None, :], P[3], P[3])
        drp[:, :, :, a] = acc * torch.exp2(cumx[:, :, :, a]) + (
            Dd[..., None] * E * kf[:, :, :, a, None, :, :]).sum(-2)
        # dk': the adjoint leaving, the strips after, the diagonal tile
        acc = mm(vf[:, :, :, a], (Gc * torch.exp2(post[:, :, :, a])[
            ..., :, None]).transpose(-1, -2), 0, P[2])
        for j in range(a + 1, NS):
            acc = acc + mm(D[:, :, :, j, :, a].transpose(-1, -2),
                           rw[:, :, :, j] * torch.exp2(sp[a + 1, j])[
                               ..., None, :], P[3], P[3])
        dkp[:, :, :, a] = acc * torch.exp2(rest[:, :, :, a]) + (
            Dd[..., None] * E * rf[:, :, :, a, :, None, :]).sum(-3)
        # dv: G_c^T k~, the scores of the strips after, the diagonal tile
        acc = mm(kw[:, :, :, a] * torch.exp2(post[:, :, :, a])[..., None, :],
                 Gc, P[4], P[4])
        for j in range(a + 1, NS):
            At = mm(kw[:, :, :, a], (rw[:, :, :, j] * torch.exp2(
                sp[a + 1, j])[..., None, :]).transpose(-1, -2), P[4], P[4])
            acc = acc + mm(At, df[:, :, :, j], P[4])
        Ad = (rf[:, :, :, a, :, None, :] * kf[:, :, :, a, None, :, :] * E
              ).sum(-1) + torch.diag_embed(
                  (rf[:, :, :, a] * u.to(dtype)[None, :, None, None, :]
                   * kf[:, :, :, a]).sum(-1))
        dv[:, :, :, a] = acc + mm(Ad.transpose(-1, -2), df[:, :, :, a],
                                  P[4])
    Dtt = torch.stack([torch.diagonal(D[:, :, :, i, :, i], dim1=-2,
                                      dim2=-1) for i in range(NS)], 3)
    U = u.to(dtype)[None, :, None, None, None, :]
    dr = drp + U * kf * Dtt[..., None]
    dk = dkp + U * rf * Dtt[..., None]
    # dlogw from the chunk-local identity
    a_ = flat(rf * drp)
    b_ = flat(kf * dkp)
    after = torch.cat([a_.flip(3).cumsum(3).flip(3)[:, :, :, 1:],
                       torch.zeros_like(a_[:, :, :, :1])], 3)
    dlogw = after - b_.flip(3).cumsum(3).flip(3) \
        + (Gc * Sn).sum(-1)[:, :, :, None, :]
    du = (rf * kf * Dtt[..., None]).sum((0, 2, 3, 4))

    def rows(t):
        return t.reshape(B, H, nc * CHUNK, dh).permute(0, 2, 1, 3)[:, :T]

    return (rows(dr), rows(dk), rows(dv.reshape(B, H, nc, CHUNK, dh)),
            rows(dlogw), du, dstate_in if state is not None else None)


def wkv_draw(seed, B, T, H, dh, logw_lo, carried, dtype=torch.float32):
    """chip_smoke.py's draws: r, k, v, do standard normal (bf16 values),
    logw log-uniform in [logw_lo, -0.001], u normal; with ``carried`` a
    state and the final state's gradient."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dtype)
    r, k, v, do = (bf16(f(B, T, H, dh)) for _ in range(4))
    lo, hi = np.log(1e-3), np.log(-logw_lo)
    logw = torch.from_numpy(-np.exp(lo + (hi - lo) * rng.random(
        (B, T, H, dh))).astype(np.float32)).to(dtype)
    u = f(H, dh)
    state, dstate = (f(B, H, dh, dh) if carried else None for _ in range(2))
    return r, k, v, logw, u, do, state, dstate


# ----------------------------------------------------------------------
# SSD
# ----------------------------------------------------------------------

def emulate_ssd_bwd(x, dt, Bm, Cm, A, dy, state=None, dstate=None,
                    P=KERNEL, dtype=torch.float32, dl_form="stable"):
    """csrc/ssd_bwd.cu's bf16 form in ``dtype`` with operands in ``P``
    pieces; ``dl_form`` "stable" (the kernel's) or "identity" (the
    cancelling form); returns (dx, ddt, dB_, dC_, dA, dstate_in or
    None)."""
    Bsz, T, H, dh = x.shape
    N = Bm.shape[-1]
    nc = -(-T // CHUNK)
    xc = chunked(x.to(dtype), T).permute(0, 3, 1, 2, 4)  # [B, H, NC, C, dh]
    yc = chunked(dy.to(dtype), T).permute(0, 3, 1, 2, 4)
    dtc = chunked(dt.to(dtype), T).permute(0, 3, 1, 2)  # [B, H, NC, C]
    bc, cc = (chunked(t.to(dtype), T)[:, None] for t in (Bm, Cm))
    lg = (dtc * A.to(dtype)[None, :, None, None] * LOG2E).reshape(
        Bsz, H, nc, NS, SUB)
    cum_s = lg.cumsum(-1)
    tot = cum_s[..., -1]  # [B, H, NC, NS]
    rest = tot[..., None] - cum_s
    sp = span_table(tot)
    pre = torch.stack([sp[0, i] for i in range(NS)], -1)
    post = torch.stack([sp[i + 1, NS] for i in range(NS)], -1)
    total = sp[0, NS]
    cum = (cum_s + pre[..., None]).reshape(Bsz, H, nc, CHUNK)
    tmc = (rest + post[..., None]).reshape(Bsz, H, nc, CHUNK)
    # L[t, s] = exp2(cum_t - cum_s), s <= t, from strip-local sums
    t_i = torch.arange(CHUNK)
    st, ss = t_i[:, None] // SUB, t_i[None, :] // SUB
    cs = cum_s.reshape(Bsz, H, nc, CHUNK)
    between = torch.stack([torch.stack([sp[min(j + 1, i), max(j + 1, i)]
                                        for j in range(NS)], -1)
                           for i in range(NS)], -2)  # [..., NS_t, NS_s]
    ex = torch.where(
        st == ss, cs[..., :, None] - cs[..., None, :],
        cs[..., :, None] + rest.reshape(Bsz, H, nc, CHUNK)[..., None, :]
        + between[..., st, ss])
    Lx = torch.exp2(torch.where(t_i[:, None] >= t_i[None, :], ex,
                                torch.full_like(ex, -torch.inf)))
    zeros = torch.zeros(Bsz, H, dh, N, dtype=dtype)
    decay = torch.exp2(total)[..., None, None]
    inc = mm(xc.transpose(-1, -2), bc * (torch.exp2(tmc) * dtc)[..., None],
             0, P[0])
    Sc, _ = forward_pass(inc, decay,
                         zeros if state is None else state.to(dtype))
    ginc = mm(yc.transpose(-1, -2), cc * torch.exp2(cum)[..., None], 0, P[1])
    Gc, dstate_in = reverse_pass(ginc, decay,
                                 zeros if dstate is None else dstate.to(dtype))
    bh, ch = bc.expand(-1, H, -1, -1, -1), cc.expand(-1, H, -1, -1, -1)
    CB = cc @ bc.transpose(-1, -2)  # [t, s]
    M = CB * Lx
    dxi = mm(bh, Gc.transpose(-1, -2), 0, P[2]) * torch.exp2(tmc)[..., None]
    dxt = dxi + mm(M.transpose(-1, -2), yc, P[3])
    W = (yc @ xc.transpose(-1, -2)) * dtc[..., None, :] * Lx  # [t, s]
    dci = mm(yc, Sc, 0, P[2]) * torch.exp2(cum)[..., None]
    dCh = dci + mm(W, bh, P[3])
    dBh = mm(xc, Gc, 0, P[4]) * (torch.exp2(tmc) * dtc)[..., None] \
        + mm(W.transpose(-1, -2), ch, P[4])
    eye = torch.eye(CHUNK, dtype=dtype)
    if dl_form == "stable":
        ia = (cc * dci).sum(-1)
        ib = dtc * (xc * dxi).sum(-1)
        E = W * CB * (1 - eye)
        Rx = torch.cat([torch.zeros_like(E[..., :1]), E.cumsum(-1)[..., :-1]],
                       -1)  # sum_{s<j} E_ts at [t, j]
        cross = torch.diagonal((Rx * torch.tril(torch.ones(
            CHUNK, CHUNK, dtype=dtype))).flip(-2).cumsum(-2).flip(-2),
            dim1=-2, dim2=-1)
        dl = ia.flip(-1).cumsum(-1).flip(-1) \
            + torch.cat([torch.zeros_like(ib[..., :1]),
                         ib.cumsum(-1)[..., :-1]], -1) \
            + (torch.exp2(total)[..., None, None] * Gc * Sc).sum(
                (-1, -2))[..., None] + cross
    else:
        Sn = torch.cat([Sc[:, :, 1:], forward_pass(
            inc, decay, zeros if state is None else state.to(dtype))[1][
                :, :, None]], 2)
        a_ = (cc * dCh).sum(-1)
        b_ = dtc * (xc * dxt).sum(-1)
        dl = a_.flip(-1).cumsum(-1).flip(-1) \
            - b_.flip(-1).cumsum(-1).flip(-1) \
            + (Gc * Sn).sum((-1, -2))[..., None]
    ddt = (xc * dxt).sum(-1) + A.to(dtype)[None, :, None, None] * dl
    dA = (dtc * dl).sum((0, 2, 3))

    def rows(t):
        return t.reshape((Bsz, H, nc * CHUNK) + t.shape[4:]).transpose(
            1, 2)[:, :T]

    dB = dBh.sum(1).reshape(Bsz, nc * CHUNK, N)[:, :T]
    dC = dCh.sum(1).reshape(Bsz, nc * CHUNK, N)[:, :T]
    return (rows(dtc[..., None] * dxt), rows(ddt), dB, dC, dA,
            dstate_in if state is not None else None)


def ssd_draw(seed, B, T, H, dh, N, dt_hi, carried, dtype=torch.float32):
    """chip_smoke.py's draws: x, dy, B_, C_ standard normal (bf16 values),
    dt uniform in [0.001, dt_hi], A uniform in [-1.5, -0.3]; with
    ``carried`` a state and the final state's gradient."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(dtype)
    x, dy = bf16(f(B, T, H, dh)), bf16(f(B, T, H, dh))
    Bm, Cm = bf16(f(B, T, N)), bf16(f(B, T, N))
    dt = torch.from_numpy(rng.uniform(0.001, dt_hi, size=(B, T, H))
                          .astype(np.float32)).to(dtype)
    A = -torch.from_numpy(rng.uniform(0.3, 1.5, size=(H,))
                          .astype(np.float32)).to(dtype)
    state, dstate = (f(B, H, dh, N) if carried else None for _ in range(2))
    return x, dt, Bm, Cm, A, dy, state, dstate


# ----------------------------------------------------------------------
# the limits
# ----------------------------------------------------------------------

def shares(names, got, plain):
    """Each output's error as a share of its chip_smoke.py limit: bf16
    outputs (dr, dk, dv, dx, dB_, dC_) elementwise within ATTN_STEPS
    unit roundoffs of |plain| plus as many of 2^-8 of the largest, the
    fp32 ones within FP32_TOL of the largest."""
    out = {}
    for name, g, p in zip(names, got, plain):
        if p is None:
            assert g is None, name
            continue
        g, p = g.double(), p.double()
        assert bool(torch.isfinite(g).all()), name
        if name in ("dr", "dk", "dv", "dx", "dB_", "dC_"):
            a = p.abs()
            lim = ATTN_STEPS * 2.0 ** -8 * (a + 2.0 ** -8 * a.max())
            out[name] = float(((g - p).abs() / lim).max())
        else:
            out[name] = float((g - p).abs().max()
                              / (FP32_TOL * p.abs().max()))
    return out


def rel_err(got, plain):
    return max(float((g.double() - p.double()).abs().max()
                     / p.double().abs().max())
               for g, p in zip(got, plain) if p is not None)


WKV_NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate")
SSD_NAMES = ("dx", "ddt", "dB_", "dC_", "dA", "dstate")

# (B, T, H, dh, logw_lo, carried): RWKV6-7B's training shape with fewer
# heads and batch rows, then the edges, strong decays and dh = 32
WKV_SHAPES = [(1, 256, 2, 64, -8.0, False), (2, 77, 2, 64, -20.0, True),
              (1, 63, 2, 64, -20.0, True), (1, 64, 2, 64, -20.0, True),
              (1, 65, 2, 32, -20.0, True), (1, 129, 2, 64, -8.0, True),
              (2, 1, 2, 64, -8.0, True)]
# (B, T, H, dh, N, dt_hi, carried): Jamba-1.5-Large's mixer shape with 2
# of its 256 heads, then the edges, strong decays (dt A down to -12) and
# the hybrid's reduced() shape (dh = 32, N = 8)
SSD_SHAPES = [(1, 4096, 2, 64, 16, 0.4, False),
              (2, 77, 4, 64, 16, 8.0, True), (1, 63, 2, 64, 16, 8.0, True),
              (1, 64, 2, 64, 16, 0.4, True), (1, 65, 3, 32, 8, 8.0, True),
              (1, 129, 3, 32, 8, 0.4, True), (2, 1, 2, 64, 16, 0.4, True)]


@pytest.mark.parametrize("B,T,H,dh,lo,carried", WKV_SHAPES)
def test_wkv6_bwd_design_fp32_matches_plain(B, T, H, dh, lo, carried):
    args = wkv_draw(T + dh, B, T, H, dh, lo, carried)
    plain = kwkv.wkv6_bwd_plain(*args)
    got = emulate_wkv6_bwd(*args, P=EXACT)
    assert rel_err(got, plain) <= 1e-5


@pytest.mark.parametrize("B,T,H,dh,lo,carried", WKV_SHAPES)
def test_wkv6_bwd_design_bf16_holds_chip_smoke_limits(B, T, H, dh, lo,
                                                      carried):
    args = wkv_draw(T + dh, B, T, H, dh, lo, carried)
    plain = kwkv.wkv6_bwd_plain(*args)
    got = shares(WKV_NAMES, emulate_wkv6_bwd(*args, P=KERNEL), plain)
    assert max(got.values()) <= 1.0, got
    assert got["dlogw"] <= 0.5, got  # half the limit, the margin kept


@pytest.mark.parametrize("B,T,H,dh,N,dt_hi,carried", SSD_SHAPES)
def test_ssd_bwd_design_fp32_matches_plain(B, T, H, dh, N, dt_hi, carried):
    args = ssd_draw(T + dh + N, B, T, H, dh, N, dt_hi, carried)
    plain = kssd.ssd_bwd_plain(*args)
    got = emulate_ssd_bwd(*args, P=EXACT)
    assert rel_err(got, plain) <= 1e-5


@pytest.mark.parametrize("B,T,H,dh,N,dt_hi,carried", SSD_SHAPES)
def test_ssd_bwd_design_bf16_holds_chip_smoke_limits(B, T, H, dh, N, dt_hi,
                                                     carried):
    args = ssd_draw(T + dh + N, B, T, H, dh, N, dt_hi, carried)
    plain = kssd.ssd_bwd_plain(*args)
    got = shares(SSD_NAMES, emulate_ssd_bwd(*args, P=KERNEL), plain)
    assert max(got.values()) <= 1.0, got
    assert max(got["ddt"], got["dA"]) <= 0.5, got


def test_the_decay_gradients_need_more_than_a_pair():
    """dlogw (WKV6) and ddt, dA (SSD) with the kernels' three pieces, with
    pairs in their place and with one rounding, at RWKV6-7B's training
    shape and at T = 512 of Jamba's mixer shape: the pieces hold half the
    limit, pairs read higher, one rounding breaks it."""
    args = wkv_draw(1, 1, 256, 2, 64, -8.0, True)
    plain = kwkv.wkv6_bwd_plain(*args)
    wkv = {name: shares(WKV_NAMES, emulate_wkv6_bwd(*args, P=P), plain)[
        "dlogw"] for name, P in (("kernel", KERNEL), ("pairs", PAIRS),
                                 ("once", ONCE))}
    args = ssd_draw(2, 1, 512, 4, 64, 16, 0.4, True)
    plain = kssd.ssd_bwd_plain(*args)
    ssd = {}
    for name, P in (("kernel", KERNEL), ("pairs", PAIRS), ("once", ONCE)):
        got = shares(SSD_NAMES, emulate_ssd_bwd(*args, P=P), plain)
        ssd[name] = max(got["ddt"], got["dA"])
    print(f"dlogw share of the limit {wkv}; ddt, dA {ssd}")
    for share in (wkv, ssd):
        assert share["kernel"] <= 0.5 \
            and share["kernel"] < share["pairs"] < share["once"], share
        assert share["once"] > 10.0, share


@pytest.mark.parametrize("B,T,H,dh,lo,carried", [(1, 130, 2, 32, -20.0, True),
                                                 (2, 64, 2, 32, -3.0, False)])
def test_wkv6_decay_identity_in_float64(B, T, H, dh, lo, carried):
    """dlogw from the chunk-local identity against the per-step
    w (x) sum_v (G (x) S_{t-1}) of wkv6_bwd_plain, both in float64."""
    args = wkv_draw(T, B, T, H, dh, lo, carried, dtype=torch.float64)
    plain = kwkv.wkv6_bwd_plain(*args)
    got = emulate_wkv6_bwd(*args, P=EXACT, dtype=torch.float64)
    assert float((got[3] - plain[3]).abs().max()) \
        <= 1e-12 * float(plain[3].abs().max())


@pytest.mark.parametrize("form", ["identity", "stable"])
@pytest.mark.parametrize("B,T,H,dh,N,dt_hi,carried",
                         [(1, 130, 2, 32, 8, 8.0, True),
                          (2, 64, 2, 32, 16, 0.4, False)])
def test_ssd_decay_identity_in_float64(form, B, T, H, dh, N, dt_hi, carried):
    """ddt and dA from the chunk-local identity, in its cancelling form
    and in the kernel's, against ssd_bwd_plain, both in float64."""
    args = ssd_draw(T, B, T, H, dh, N, dt_hi, carried, dtype=torch.float64)
    plain = kssd.ssd_bwd_plain(*args)
    got = emulate_ssd_bwd(*args, P=EXACT, dtype=torch.float64, dl_form=form)
    for i in (1, 4):
        assert float((got[i] - plain[i]).abs().max()) \
            <= 1e-11 * float(plain[i].abs().max())


def test_the_cancelling_form_misses_the_limit_at_strong_decays():
    """In fp32 operands, the SSD identity's cancelling form reads dA
    higher than the kernel's form at decays down to dt A = -12."""
    args = ssd_draw(2, 2, 200, 8, 64, 16, 8.0, True)
    plain = kssd.ssd_bwd_plain(*args)
    stable, cancelling = (shares(SSD_NAMES, emulate_ssd_bwd(
        *args, P=KERNEL, dl_form=form), plain)["dA"]
        for form in ("stable", "identity"))
    assert stable <= 0.5 < cancelling, (stable, cancelling)


def test_the_sources_take_these_shapes():
    for name in ("wkv6_chunk.cuh", "ssd_chunk.cuh"):
        src = (CSRC / name).read_text()
        assert int(re.search(r"constexpr int kChunk = (\d+);", src)[1]) \
            == CHUNK
        assert int(re.search(r"constexpr int kSub = (\d+);", src)[1]) == SUB
        # the prefill's increments, whose states the backward takes
        assert re.search(r"int kPieces = (\d+)>", src)[1] == str(KERNEL[0])
    for name in ("wkv6_bwd.cu", "ssd_bwd.cu"):
        src = (CSRC / name).read_text()
        assert int(re.search(r"constexpr int kPieces = (\d+);", src)[1]) \
            == KERNEL[1] == KERNEL[2] == KERNEL[3]
