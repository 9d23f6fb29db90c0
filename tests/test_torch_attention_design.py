"""The arithmetic of the port's two attention kernels' designs, on the
CPU: what the CUDA kernels compute in another form, held to the plain
versions they are compared with on the card.

* ``paged_attention`` cuts each sequence's keys into splits of whole
  pages (``split_plan``) and merges the splits' softmax partials
  (``merge_partials``, the plain form of the kernel's merge).  Partials
  computed plainly, split by split and, inside a split, 32-key chunk by
  chunk as the kernel's teams do, merged, must equal
  ``paged_attention_plain`` within 1e-5 of the largest output magnitude
  (fp32: the same sums in another order), empty splits included, and
  give exact zeros for a sequence of length 0.  With a sliding window
  each block starts its split's keys at the sequence's first live key,
  max(0, len - window) (``window_start``, the kernel's ``base``): the
  model reads no key before it, a split that lies wholly before it
  stores the empty partial, and the merge equals
  ``paged_attention_plain(window=...)``.
* ``flash_attention`` in bf16 multiplies P by V on the tensor cores as
  P_hi = bf16(P) plus P_lo = bf16(P - P_hi).  Emulated tile by tile
  (64 keys, scores in log2 units, fp32 sums) at Qwen2-0.5B's prefill
  shape, it must hold to chip_smoke.py's elementwise limit against
  ``attention_plain``: ATTN_STEPS bf16 unit roundoffs (2^-8) of each
  plain value plus as many of 2^-8 of the largest.  A P rounded once to
  bf16 breaks that limit on the same inputs, which is why the kernel
  keeps the second product.

Inputs are drawn with numpy from a seed.
"""

import inspect
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.kernels.paged_attention import kernel as paged_kernel

CHUNK = 32  # keys a team of the paged kernel scores at a time
TILE = 64  # keys of a flash_attention stage
ATTN_STEPS = 4  # chip_smoke.py's limit for the bf16 attention kernels


def normal(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def partial(q, k, v, live):
    """One split's (or chunk's) softmax partial, plainly: q [H, dh], k and
    v [n, dh] fp32, live [n] bool -> m [H] (-1e30 with no live key), l [H],
    acc [H, dh]."""
    s = (q @ k.T) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~live[None, :], float("-inf"))
    m = s.amax(dim=-1).clamp_min(-1e30) if s.shape[-1] else \
        torch.full(q.shape[:1], -1e30)
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=-1), p @ v


def window_start(lo, split_hi, length, window):
    """The kernel's ``base``: the first key a split's block reads, its
    own first key or the sequence's first live key, split_hi where that
    lies past the split."""
    first = max(0, length - window) if window else 0
    return max(lo, min(split_hi, first))


def split_partials(q, pages_k, pages_v, table, lens, pages, n_splits,
                   window=None, read=None):
    """Each split's partial, merged from its 32-key chunks (from the
    split's ``window_start`` on) as the kernel's teams do: m, l [B, H,
    n_splits], acc [B, H, n_splits, dh].  ``read``, where given, gathers
    the keys each split stages for scoring: {(b, split): [key, ...]}."""
    B, H, dh = q.shape
    _, PS, Hk, _ = pages_k.shape
    maxp = table.shape[1]
    G = H // Hk
    ms = torch.empty(B, H, n_splits)
    ls = torch.empty(B, H, n_splits)
    accs = torch.empty(B, H, n_splits, dh)
    for b in range(B):
        length = max(0, min(int(lens[b]), maxp * PS))
        rows = table[b].long().clamp_min(0)
        keys_k = pages_k[rows].reshape(maxp * PS, Hk, dh).float()
        keys_v = pages_v[rows].reshape(maxp * PS, Hk, dh).float()
        for s in range(n_splits):
            lo = s * pages * PS
            hi = min(lo + pages * PS, maxp * PS)
            base = window_start(lo, hi, length, window)
            # keys past min(hi, length) are staged, never scored
            chunks = range(base, max(base, min(hi, length)), CHUNK)
            if read is not None:
                read[b, s] = [j for c0 in chunks
                              for j in range(c0, min(c0 + CHUNK, hi))]
            for hk in range(Hk):
                heads = slice(hk * G, (hk + 1) * G)
                parts = []
                for c0 in chunks:
                    idx = torch.arange(c0, min(c0 + CHUNK, hi))
                    parts.append(partial(q[b, heads].float(),
                                         keys_k[idx, hk], keys_v[idx, hk],
                                         idx < length))
                if not parts:
                    parts.append((torch.full((G,), -1e30), torch.zeros(G),
                                  torch.zeros(G, dh)))
                m, l, acc = (torch.stack(t, dim=-1) for t in zip(*parts))
                # the chunks' partials merge into the split's
                mm = m.amax(dim=-1)
                w = torch.exp(m - mm[:, None])
                ms[b, heads, s] = mm
                ls[b, heads, s] = (w * l).sum(dim=-1)
                accs[b, heads, s] = (w[:, None, :] * acc).sum(dim=-1)
    return ms, ls, accs


@pytest.mark.parametrize("B,H,Hk,dh,NP,PS,MAXP,lens", [
    (1, 14, 2, 64, 34, 16, 34, [529]),      # Qwen2-0.5B decode
    (1, 14, 2, 64, 34, 16, 34, [310]),      # the last splits empty
    (1, 14, 2, 64, 34, 16, 34, [544]),      # len = MAXP * PS
    (1, 14, 2, 64, 34, 16, 34, [0]),        # every split empty
    (1, 4, 1, 32, 40, 16, 34, [80]),        # the hybrid at reduced()
    (1, 4, 1, 32, 40, 16, 34, [81]),        # a split boundary + 1
    (2, 8, 8, 128, 16, 64, 8, [1, 511]),    # G = 1
    (4, 14, 2, 64, 160, 16, 34, [0, 1, 79, 544]),
    (3, 64, 1, 64, 40, 16, 20, [5, 0, 320]),  # G = 64
])
def test_merge_partials_matches_plain_version(B, H, Hk, dh, NP, PS, MAXP,
                                              lens):
    rng = np.random.default_rng(B * 1000 + H * 10 + dh + sum(lens))
    q = normal(rng, (B, H, dh))
    pk, pv = normal(rng, (NP, PS, Hk, dh)), normal(rng, (NP, PS, Hk, dh))
    table = torch.from_numpy(
        rng.integers(0, NP, size=(B, MAXP)).astype(np.int32))
    table[0, -1] = -1  # reads page 0
    lt = torch.tensor(lens, dtype=torch.int32)
    pages, n_splits = kpaged.split_plan(MAXP, B, H, Hk)
    m, l, acc = split_partials(q, pk, pv, table, lt, pages, n_splits)
    got = kpaged.merge_partials(m, l, acc)
    want = kpaged.paged_attention_plain(q, pk, pv, table, lt)
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.parametrize("H,Hk,dh,MAXP,window,lens", [
    # StarCoder2's decode: 8 splits of 35 pages, the window of 4096
    (48, 4, 128, 275, 4096, [4353, 4384, 4096, 4097]),
    (48, 4, 128, 275, 4096, [300, 4400]),         # window >= len; MAXP * PS
    (14, 2, 64, 34, 100, [529, 357]),            # Qwen2's shape, mid-page
    (14, 2, 64, 34, 64, [544, 80]),               # starts on a page edge
    (14, 2, 64, 34, 20, [544, 541, 530]),         # inside the last split
    (4, 1, 32, 34, 64, [64, 65, 200, 1]),         # Mixtral reduced: G = 4
    (4, 1, 32, 34, 1, [17, 0]),                   # the newest key alone
])
def test_window_start_matches_plain_version(H, Hk, dh, MAXP, window, lens):
    """The kernel's window start under ``split_plan``: the merged
    partials equal ``paged_attention_plain(window=...)``; no key before
    the window is read, nor any page wholly before it; a split that lies
    wholly before the window reads nothing and stores the empty partial
    (m = -1e30, l = 0)."""
    PS, B = 16, len(lens)
    rng = np.random.default_rng(window + sum(lens))
    q = normal(rng, (B, H, dh))
    NP = B * MAXP
    pk, pv = normal(rng, (NP, PS, Hk, dh)), normal(rng, (NP, PS, Hk, dh))
    table = torch.from_numpy(
        rng.permutation(NP).reshape(B, MAXP).astype(np.int32))
    lt = torch.tensor(lens, dtype=torch.int32)
    pages, n_splits = kpaged.split_plan(MAXP, B, H, Hk)
    read = {}
    m, l, acc = split_partials(q, pk, pv, table, lt, pages, n_splits,
                               window, read)
    got = kpaged.merge_partials(m, l, acc)
    want = kpaged.paged_attention_plain(q, pk, pv, table, lt, window=window)
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    for b, n in enumerate(lens):
        first = max(0, n - window)
        for s in range(n_splits):
            keys = read[b, s]
            assert all(j >= first for j in keys)
            assert all(j // PS >= first // PS for j in keys)  # no dead page
            split_hi = min((s + 1) * pages * PS, MAXP * PS)
            if split_hi <= first or s * pages * PS >= n:
                assert keys == []
                assert torch.equal(m[b, :, s], torch.full((H,), -1e30))
                assert torch.equal(l[b, :, s], torch.zeros(H))
        # every live key is read, by exactly one split
        live = sorted(j for s in range(n_splits) for j in read[b, s]
                      if j < n)
        assert live == list(range(first, n))


def test_merge_partials_of_empty_splits_is_zero():
    m = torch.full((2, 3, 4), -1e30)
    out = kpaged.merge_partials(m, torch.zeros(2, 3, 4),
                                torch.zeros(2, 3, 4, 8))
    assert torch.equal(out, torch.zeros(2, 3, 8))


@pytest.mark.parametrize("max_pages", [0, 1, 3, 8, 34, 35, 100, 1000])
@pytest.mark.parametrize("batch,heads,kv_heads", [
    (1, 14, 2), (1, 4, 1), (1, 8, 8), (4, 14, 2), (8, 14, 2),
    (64, 32, 8), (2, 64, 1),
])
def test_split_plan_covers_every_page_once(max_pages, batch, heads,
                                           kv_heads):
    pages, n_splits = kpaged.split_plan(max_pages, batch, heads, kv_heads)
    assert n_splits in (1, 2, 4, 8) and pages >= 1
    covered = np.zeros(max_pages, int)
    for s in range(n_splits):
        covered[s * pages:(s + 1) * pages] += 1
    assert (covered == 1).all()  # every page of the table, once
    # no more splits than pages, and the grid within half the SMs
    # unless one split a sequence already exceeds it
    group_size = heads // kv_heads
    groups = -(-group_size // paged_kernel.heads_per_block(group_size))
    blocks = batch * kv_heads * groups
    assert n_splits == 1 or (n_splits <= max_pages
                             and 2 * n_splits * blocks <= 132)


def test_split_plan_never_sees_the_lengths():
    """The plan, and so the grid, comes from the table's shape and the
    SM count alone: seq_lens stay on the device."""
    params = list(inspect.signature(kpaged.split_plan).parameters)
    assert params == ["max_pages", "batch", "heads", "kv_heads", "sms"]
    # Qwen2-0.5B's decode at one sequence: 8 splits of 5 pages
    assert kpaged.split_plan(34, 1, 14, 2) == (5, 8)


@pytest.mark.parametrize("group_size", [1, 2, 4, 5, 7, 8, 9, 14, 32, 33,
                                        64])
def test_heads_per_block_is_a_count_the_cuda_kernel_builds(group_size):
    """The wrapper chooses the heads a block computes and the CUDA
    source builds kHeads = 1, 2 or 8 heads a warp of a kTeamWarps-warp
    team: the choice is one of those counts, the fewest that hold the
    group (up to the largest), so split_plan counts the grid's blocks."""
    src = (pathlib.Path(paged_kernel.__file__).parents[2] / "csrc"
           / "paged_attention.cu").read_text()
    team_warps = int(re.search(r"constexpr int kTeamWarps = (\d+);",
                               src).group(1))
    cases = re.findall(r"case (?:(\d+) \* )?kTeamWarps:", src)
    built = sorted(int(k or 1) * team_warps for k in cases)
    assert built == [4, 8, 32]
    got = paged_kernel.heads_per_block(group_size)
    assert got == min([n for n in built if n >= group_size] or [built[-1]])


def emulate_flash(q, k, v, split_p):
    """The bf16 kernel's arithmetic (causal): 64-key tiles, scores in log2
    units, an online softmax in fp32, P.V with P as bf16 hi + lo (or hi
    alone), fp32 sums, the output rounded once to q's dtype."""
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    head = torch.arange(H) // (H // Hk)
    qf = q.float().transpose(1, 2)
    kf = k.float()[:, :, head].transpose(1, 2)
    vf = v.float()[:, :, head].transpose(1, 2)
    c = 1.0 / math.sqrt(dh) * math.log2(math.e)
    m = torch.full((B, H, T, 1), -1e30)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, dh)
    qpos = torch.arange(T)[:, None] + (S - T)
    for t0 in range(0, S, TILE):
        s = torch.matmul(qf, kf[:, :, t0:t0 + TILE].transpose(-1, -2)) * c
        kpos = torch.arange(t0, min(S, t0 + TILE))[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, t0:t0 + TILE]
        pv = torch.matmul(hi, vt)
        if split_p:
            pv = pv + torch.matmul((p - hi).to(torch.bfloat16).float(), vt)
        acc = acc * alpha + pv
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def test_p_hi_lo_holds_chip_smoke_limit_at_qwen2_prefill():
    rng = np.random.default_rng(512)
    q = normal(rng, (1, 512, 14, 64), torch.bfloat16)
    k = normal(rng, (1, 512, 2, 64), torch.bfloat16)
    v = normal(rng, (1, 512, 2, 64), torch.bfloat16)
    plain = kflash.attention_plain(q, k, v).float()
    limit = ATTN_STEPS * 2.0 ** -8 * (plain.abs()
                                      + 2.0 ** -8 * plain.abs().max())
    split = (emulate_flash(q, k, v, split_p=True).float() - plain).abs()
    assert bool((split <= limit).all()), float((split / limit).max())
    once = (emulate_flash(q, k, v, split_p=False).float() - plain).abs()
    assert int((once > limit).sum()) > 0  # one rounding of P shows
