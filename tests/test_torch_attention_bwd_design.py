"""The design of the attention backward kernels
(``csrc/flash_attention_bwd.cu``), on the CPU: what the CUDA kernels
compute, modelled tile by tile, held to the plain version they are
compared with on the card.

* Tile coverage.  Kernel A (dq) runs one block per (64 query rows,
  query head, batch) and walks the key tiles its rows can see; kernel B
  (dk, dv) runs one block per (64 keys, query head, batch) and walks the
  query tiles that see its keys.  Both walks, modelled from the
  source's bounds with the tile read from the source, must cover every
  (query, key) pair the mask leaves exactly once, and walk no tile in
  which no pair is left, for causal and windowed masks, T < S, T > S,
  T not a multiple of 64, and without a mask.  Kernel B's grid runs
  over query heads, so each kv head's gradient is its group's partials.
* Arithmetic.  The kernels' bf16 arithmetic emulated tile by tile: P =
  exp2(S * scale * log2 e - LSE * log2 e) with LSE the forward's
  (``attention_plain(..., return_lse=True)``, the value the card's
  forward is held to), dS = P * (dP - D), the three register operands
  (P in dv, dS in dq, dS in dk) split as bf16 hi + lo, fp32 sums, each
  query head's dk and dv summed into its kv head in fixed head order,
  each output rounded once to bf16.  It must hold to
  ``attention_bwd_plain`` within chip_smoke.py's elementwise limit
  (ATTN_STEPS bf16 unit roundoffs, 2^-8, of each plain value plus as
  many of 2^-8 of the largest) at MiniCPM-2B's training shape and
  Qwen2-0.5B's heads at T = 512.
* The single-rounding break.  Rounding any one of those operands once
  to bf16 breaks that limit on the same inputs: that is why the kernels
  keep the second product for each.
* LSE.  The plain forward's log-sum-exp agrees with a float64 numpy
  logsumexp of the masked scores within 1e-6 of max(1, |value|), is
  +inf on rows that see no key, and its output still matches the JAX
  package's ``attention_ref``.

Inputs are drawn with numpy from a seed.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro_torch.kernels import flash_attention as kflash

CSRC = pathlib.Path(kflash.__file__).parents[2] / "csrc"
BWD_SRC = (CSRC / "flash_attention_bwd.cu").read_text()
ATTN_STEPS = 4  # chip_smoke.py's limit for the bf16 attention kernels
LOG2E = math.log2(math.e)


def read_tile() -> int:
    """The bf16 kernels' tile (``kTile``, from the header the backward's
    source includes), which the fp32 kernels' kBQ and kBK equal."""
    header = re.search(r'#include "(\w+\.cuh)"', BWD_SRC).group(1)
    tile = int(re.search(r"constexpr int kTile = (\d+);",
                         (CSRC / header).read_text()).group(1))
    for name in ("kBQ", "kBK"):
        got = int(re.search(rf"constexpr int {name} = (\d+);",
                            BWD_SRC).group(1))
        assert got == tile, (name, got, tile)
    return tile


TILE = read_tile()


def mask_of(T, S, causal, window):
    """[T, S] bool: query i (at position i + S - T) sees key j."""
    if not causal:
        return np.ones((T, S), bool)
    pos = np.arange(T)[:, None] + (S - T)
    key = np.arange(S)[None, :]
    m = key <= pos
    if window is not None:
        m &= key > pos - window
    return m


def a_key_tiles(q0, T, S, causal, window):
    """Kernel A's walk: the first keys of the tiles the block of query
    rows q0 .. q0 + 63 reads (``k_lo``, ``k_hi``, ``t_first``)."""
    k_lo, k_hi = 0, S
    if causal:
        off = S - T
        k_hi = min(S, min(q0 + TILE, T) + off)
        if window is not None:
            k_lo = max(0, q0 + off - window + 1)
    first = k_lo // TILE * TILE
    return list(range(first, k_hi, TILE))


def b_query_tiles(c0, T, S, causal, window):
    """Kernel B's walk: the first rows of the query tiles the block of
    keys c0 .. c0 + 63 reads (``i_lo``, ``i_hi``, ``i_first``)."""
    i_lo, i_hi = 0, T
    if causal:
        off = S - T
        i_lo = max(0, c0 - off)
        if window is not None:
            i_hi = min(T, min(c0 + TILE, S) - 1 + window - off)
    first = i_lo // TILE * TILE
    return list(range(first, i_hi, TILE))


COVER_CASES = [
    # T, S, causal, window
    (64, 64, True, None),
    (512, 512, True, None),       # Qwen2-0.5B's T = 512
    (1100, 1100, True, 512),      # StarCoder2-15B's heads, a window
    (300, 300, True, 100),        # a window that masks keys, ragged T
    (65, 200, True, 70),          # T < S with a window
    (37, 90, True, None),         # T < S
    (100, 40, True, None),        # T > S: 60 rows see no key
    (150, 20, True, None),
    (129, 129, True, None),       # T not a multiple of 64
    (1, 1, True, None),
    (70, 90, False, None),        # no mask
    (200, 64, False, None),
    (4352, 4352, True, 4096),     # StarCoder2's long prompt
]


@pytest.mark.parametrize("T,S,causal,window", COVER_CASES)
def test_kernel_a_walk_covers_every_pair_once(T, S, causal, window):
    m = mask_of(T, S, causal, window)
    seen = np.zeros((T, S), int)
    for q0 in range(0, T, TILE):
        for t0 in a_key_tiles(q0, T, S, causal, window):
            block = m[q0:q0 + TILE, t0:t0 + TILE]
            assert block.any(), (q0, t0)  # no tile walked for nothing
            seen[q0:q0 + TILE, t0:t0 + TILE] += block
    assert np.array_equal(seen, m.astype(int))


@pytest.mark.parametrize("T,S,causal,window", COVER_CASES)
def test_kernel_b_walk_covers_every_pair_once(T, S, causal, window):
    m = mask_of(T, S, causal, window)
    seen = np.zeros((T, S), int)
    for c0 in range(0, S, TILE):
        for qt in b_query_tiles(c0, T, S, causal, window):
            block = m[qt:qt + TILE, c0:c0 + TILE]
            assert block.any(), (c0, qt)
            seen[qt:qt + TILE, c0:c0 + TILE] += block
    assert np.array_equal(seen, m.astype(int))


def test_kernel_grids_run_over_query_heads():
    """Both bf16 grids are (tiles, query heads, batch): kernel B's runs
    over query heads, not kv heads, so each (key tile, query head) has
    one block and a kv head's gradient is its group's partials, summed
    by kernel C from the group's first head to its last."""
    assert re.search(r"const dim3 grid_a\(\(t_len \+ kTile - 1\) / kTile, "
                     r"heads, batch\);", BWD_SRC)
    assert re.search(r"const dim3 grid_b\(\(s_len \+ kTile - 1\) / kTile, "
                     r"heads, batch\);", BWD_SRC)
    body = BWD_SRC[BWD_SRC.index("dkv_group_sum_kernel("):]
    assert re.search(r"for \(int g = 1; g < group; \+\+g\)", body)


def hilo(x, split):
    """x as the kernel hands it to wgmma: bf16(x) + bf16(x - bf16(x)),
    or bf16(x) alone."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


SPLITS = ("p_dv", "ds_dq", "ds_dk")  # the operands the kernels split


def emulate_bwd(q, k, v, out, dout, lse, window=None, split=SPLITS):
    """The bf16 kernels' arithmetic (causal), tile by tile along the
    kernels' walks; ``split`` names the operands taken as hi + lo."""
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    head = torch.arange(H) // G
    qf = q.float().transpose(1, 2)                       # [B, H, T, dh]
    kf = k.float()[:, :, head].transpose(1, 2)           # [B, H, S, dh]
    vf = v.float()[:, :, head].transpose(1, 2)
    of = out.float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    scale = 1.0 / math.sqrt(dh)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = (lse.float() * torch.tensor(LOG2E, dtype=torch.float32))
    d = (dof * of).sum(-1)                               # [B, H, T]
    m = torch.from_numpy(mask_of(T, S, True, window))

    def tile(i0, j0):
        """P and dS of query rows i0 .. + 63 against keys j0 .. + 63."""
        rows, cols = slice(i0, i0 + TILE), slice(j0, j0 + TILE)
        s = torch.matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2))
        dp = torch.matmul(dof[:, :, rows], vf[:, :, cols].transpose(-1, -2))
        p = torch.exp2(s * c - lse2[:, :, rows, None])
        p = p.masked_fill(~m[rows, cols], 0.0)
        return p, p * (dp - d[:, :, rows, None])

    dq = torch.zeros(B, H, T, dh)
    for q0 in range(0, T, TILE):
        for t0 in a_key_tiles(q0, T, S, True, window):
            _, ds = tile(q0, t0)
            dq[:, :, q0:q0 + TILE] += torch.matmul(
                hilo(ds, "ds_dq" in split), kf[:, :, t0:t0 + TILE])
    dk = torch.zeros(B, H, S, dh)
    dv = torch.zeros(B, H, S, dh)
    for c0 in range(0, S, TILE):
        for qt in b_query_tiles(c0, T, S, True, window):
            p, ds = tile(qt, c0)
            dv[:, :, c0:c0 + TILE] += torch.matmul(
                hilo(p, "p_dv" in split).transpose(-1, -2),
                dof[:, :, qt:qt + TILE])
            dk[:, :, c0:c0 + TILE] += torch.matmul(
                hilo(ds, "ds_dk" in split).transpose(-1, -2),
                qf[:, :, qt:qt + TILE])

    def group_sum(g):  # kernel C: the group's heads in order, fp32
        g = g.reshape(B, Hk, G, S, dh)
        acc = g[:, :, 0].clone()
        for i in range(1, G):
            acc = acc + g[:, :, i]
        return acc.transpose(1, 2).to(q.dtype)

    return ((dq * scale).transpose(1, 2).to(q.dtype),
            group_sum(dk * scale), group_sum(dv))


def limit(plain):
    p = plain.float().abs()
    return ATTN_STEPS * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())


def draw(rng, shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


DESIGN_SHAPES = {
    # B, T, H, Hk, dh: chip_smoke.py's BWD_SHAPES without the window
    "minicpm-2b": (8, 64, 36, 36, 64),
    "qwen2-0.5b-t512": (1, 512, 14, 2, 64),
}


def design_inputs(name):
    B, T, H, Hk, dh = DESIGN_SHAPES[name]
    rng = np.random.default_rng(T * H + dh)
    q = draw(rng, (B, T, H, dh))
    k, v = (draw(rng, (B, T, Hk, dh)) for _ in range(2))
    dout = draw(rng, (B, T, H, dh))
    out, lse = kflash.attention_plain(q, k, v, return_lse=True)
    plain = kflash.attention_bwd_plain(q, k, v, out, dout)
    return (q, k, v, out, dout, lse), plain


def worst(got, plain):
    """The largest |got - plain| over the limit, over dq, dk, dv."""
    return max(float(((g.float() - p.float()).abs() / limit(p)).max())
               for g, p in zip(got, plain))


@pytest.mark.parametrize("name", sorted(DESIGN_SHAPES))
def test_split_design_holds_chip_smoke_limit(name):
    args, plain = design_inputs(name)
    got = emulate_bwd(*args)
    for g, p in zip(got, plain):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
    ratio = worst(got, plain)
    assert ratio <= 1.0, ratio
    # what is left is mostly each output's one rounding to bf16 (half a
    # bf16 step, an eighth of the limit at 4 steps)
    assert ratio <= 0.6, ratio


@pytest.mark.parametrize("operand", SPLITS)
@pytest.mark.parametrize("name", sorted(DESIGN_SHAPES))
def test_one_rounding_of_a_split_operand_breaks_the_limit(name, operand):
    args, plain = design_inputs(name)
    split = tuple(s for s in SPLITS if s != operand)
    ratio = worst(emulate_bwd(*args, split=split), plain)
    assert ratio > 1.0, ratio


def test_emulation_takes_the_group_in_head_order_and_a_window():
    """StarCoder2-15B's group of 12 query heads a kv head, cut to one kv
    head and T = 300 with a window of 100 (ragged, keys masked on both
    sides of a tile): the emulation holds the limit there too."""
    rng = np.random.default_rng(300)
    q = draw(rng, (1, 300, 12, 128))
    k, v = (draw(rng, (1, 300, 1, 128)) for _ in range(2))
    dout = draw(rng, (1, 300, 12, 128))
    out, lse = kflash.attention_plain(q, k, v, window=100, return_lse=True)
    plain = kflash.attention_bwd_plain(q, k, v, out, dout, window=100)
    assert worst(emulate_bwd(q, k, v, out, dout, lse, window=100),
                 plain) <= 1.0


LSE_CASES = [
    # B, T, S, H, Hk, dh, causal, window
    (2, 64, 64, 4, 4, 64, True, None),
    (1, 129, 129, 4, 2, 32, True, None),
    (1, 100, 100, 6, 2, 64, True, 24),
    (1, 37, 90, 4, 1, 64, True, None),     # T < S
    (1, 100, 40, 4, 2, 32, True, None),    # T > S: 60 rows see no key
    (1, 50, 60, 2, 1, 128, False, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,Hk,dh,causal,window", LSE_CASES)
def test_plain_lse_is_the_masked_logsumexp(B, T, S, H, Hk, dh, causal,
                                           window, dtype):
    rng = np.random.default_rng(T * 3 + S + dh)
    q = draw(rng, (B, T, H, dh), dtype)
    k, v = (draw(rng, (B, S, Hk, dh), dtype) for _ in range(2))
    out, lse = kflash.attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    assert torch.equal(out, kflash.attention_plain(q, k, v, causal=causal,
                                                   window=window))
    # float64 numpy: s = q . k / sqrt(dh) over each head's kv head
    qn = q.double().numpy().transpose(0, 2, 1, 3)
    kn = np.repeat(k.double().numpy(), H // Hk, axis=2).transpose(0, 2, 1, 3)
    s = qn @ kn.transpose(0, 1, 3, 2) / math.sqrt(dh)
    m = mask_of(T, S, causal, window)
    s = np.where(m, s, -np.inf)
    live = np.broadcast_to(m.any(-1), lse.shape)  # [B, H, T]
    rows = s[live]
    top = rows.max(-1, keepdims=True)
    want = np.full(lse.shape, np.inf)
    want[live] = (top + np.log(np.exp(rows - top).sum(-1,
                                                       keepdims=True)))[:, 0]
    got = lse.double().numpy()
    assert np.array_equal(np.isinf(got), ~live)
    assert (got[~live] > 0).all()  # +inf, so P = exp(s - LSE) is 0
    gap = np.abs(got[live] - want[live]) / np.maximum(1.0,
                                                      np.abs(want[live]))
    assert float(gap.max(initial=0.0)) <= 1e-6
    # the output with LSE asked for is still the JAX package's
    # attention_ref (kv heads repeated), on the rows that see a key
    ref = np.asarray(attention_ref(
        jnp.asarray(q.float().numpy()).transpose(0, 2, 1, 3),
        jnp.repeat(jnp.asarray(k.float().numpy()), H // Hk,
                   axis=2).transpose(0, 2, 1, 3),
        jnp.repeat(jnp.asarray(v.float().numpy()), H // Hk,
                   axis=2).transpose(0, 2, 1, 3),
        causal=causal, window=window)).transpose(0, 2, 1, 3)
    seen = live.transpose(0, 2, 1)  # [B, T, H]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float(np.abs(out.float().numpy() - ref)[seen].max()) < tol
