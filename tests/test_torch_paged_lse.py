"""The paged-attention kernel's log-sum-exp and the slot-sharded decode
that merges by it (repro_torch, device="cpu": the plain versions).

* ``paged_attention_plain(..., return_lse=True)``: the log-sum-exp
  against ``torch.logsumexp`` of the masked scores in float64, for fp32,
  bf16 and int8 pages through shuffled pages, with a window, a length of
  0, a negative length and lengths past the table (the window then
  starting at the unclamped length): within 1e-5 of max(1, |lse|); -inf
  and a zero output where no key is live; the output equal bit for bit
  to the call without the flag.
* A random cache cut into 2, 4 and 8 slot shards, each attended with its
  own length ``pos + 1 - off`` (``attend_slot_shard``) and merged by
  log-sum-exp (``merge_by_lse``, with a max and a sum over the stacked
  shards standing in for the all-reduces), against the unsharded plain
  version: fp32 within 1e-6 of the largest output, windows across shard
  borders and sequences whose every live key lies on one shard.
* The same cut and merge inside one decode step (projection, RoPE, the
  cache written at ``pos``) against the JAX package's ``attn_decode``
  on the same numpy inputs, CodeQwen1.5-7B ``reduced()`` and
  StarCoder2-15B ``reduced()`` with its window of 64: output and cache
  within 1e-5 of their largest magnitude (fp32, as
  ``tests/test_torch_window.py``).
* On ``meta`` the wrapper charges the log-sum-exp's fp32 store, and the
  dry run's slot-sharded decode (``kv_seqshard`` on a (2, 4) mesh)
  charges ``paged_attention`` once a layer and runs no einsum,
  ``masked_fill`` or fp32 copy of the cache.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.analysis import roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshSpec, device_mesh
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models.common import apply_rope

LSE_TOL = 1e-5  # of max(1, |lse|): fp32 against float64
MERGE_TOL = 1e-6  # of the largest output: fp32, another order of sums
JAX_TOL = 1e-5  # of the largest magnitude, as tests/test_torch_window.py
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def pages_of(rng, NP, PS, Hk, dh, kind):
    """Random pages of ``kind`` and the kv_scale that reads them."""
    if kind == "int8":
        return (torch.from_numpy(rng.integers(-127, 128, (NP, PS, Hk, dh))
                                 .astype(np.int8)), 1.0 / 32)
    return (torch.from_numpy(rng.normal(size=(NP, PS, Hk, dh))
                             .astype(np.float32)).to(DTYPES[kind]), None)


def reference_lse(q, pk, pv, table, lens, window, kv_scale):
    """The masked scores' logsumexp in float64 (-inf with no live key)."""
    B, H, dh = q.shape
    _, PS, Hk, _ = pk.shape
    k = pk[table.long().clamp_min(0)].reshape(B, -1, Hk, dh).double()
    if kv_scale is not None:
        k = k * kv_scale
    k = k.repeat_interleave(H // Hk, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.double(), k) / math.sqrt(dh)
    j = torch.arange(s.shape[-1])[None, :]
    live = j < lens.long()[:, None]
    if window is not None:
        live &= j >= lens.long()[:, None] - window
    return torch.logsumexp(s.masked_fill(~live[:, None, :], -math.inf), -1)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("window", [None, 20])
def test_plain_lse_matches_logsumexp(kind, window):
    """Lengths 0, -3, 1, mid-table, the table's end and past it (where a
    window starts at the unclamped length: 150 - 20 reads keys 130..143
    of a 144-key table, 200 - 20 none)."""
    rng = np.random.default_rng(7)
    H, Hk, dh, PS, MAXP, NP = 8, 2, 32, 16, 9, 24
    lens = torch.tensor([0, -3, 1, 57, MAXP * PS, 150, 200],
                        dtype=torch.int32)
    B = lens.numel()
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(B, H, dh)).astype(np.float32)
                         ).to(qdt)
    pk, scale = pages_of(rng, NP, PS, Hk, dh, kind)
    pv, _ = pages_of(rng, NP, PS, Hk, dh, kind)
    table = torch.from_numpy(np.stack([rng.permutation(NP)[:MAXP]
                                       for _ in range(B)]).astype(np.int32))
    table[3, 5:] = -1  # unused entries past the live pages
    out, lse = kpaged.paged_attention(q, pk, pv, table, lens, window,
                                      kv_scale=scale, return_lse=True)
    assert out.dtype == qdt and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H)
    want = reference_lse(q, pk, pv, table, lens, window, scale)
    empty = torch.isinf(want)
    if window is None:
        assert empty.tolist() == [[n <= 0] * H for n in lens.tolist()]
    else:
        assert empty.tolist() == [[n <= 0 or n - window >= MAXP * PS] * H
                                  for n in lens.tolist()]
    assert torch.equal(torch.isinf(lse), empty) and bool((lse[empty] < 0)
                                                         .all())
    live = ~empty
    gap = (lse.double() - want).abs()[live] / want.abs()[live].clamp_min(1)
    assert float(gap.max()) <= LSE_TOL
    assert not torch.isnan(out.float()).any()
    assert torch.equal(out[empty.all(-1)],
                       torch.zeros_like(out[empty.all(-1)]))
    assert torch.equal(out, kpaged.paged_attention(
        q, pk, pv, table, lens, window, kv_scale=scale))


def test_past_the_table_reads_the_table_with_the_window_unclamped():
    """A length past MAXP * PS is the table's whole length without a
    window, and with one the window counted from the length itself."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 4, 32)).astype(np.float32))
    pk, pv = (pages_of(rng, 8, 16, 1, 32, "fp32")[0] for _ in range(2))
    table = torch.arange(8, dtype=torch.int32)[None]
    at = lambda n, w=None: kpaged.paged_attention(
        q, pk, pv, table, torch.tensor([n], dtype=torch.int32), w,
        return_lse=True)
    for a, b in zip(at(1000), at(128)):
        assert torch.equal(a, b)
    for a, b in zip(at(150, 30), at(128, 8)):  # keys 120..127 either way
        assert torch.equal(a, b)


def slot_shards(rng, B, S, Hk, dh, n):
    """A random cache [B, S, Hk, dh] and its n shards' (off, k, v)."""
    ck, cv = (torch.from_numpy(rng.normal(size=(B, S, Hk, dh))
                               .astype(np.float32)) for _ in range(2))
    w = S // n
    return ck, cv, [(i * w, ck[:, i * w:(i + 1) * w].contiguous(),
                     cv[:, i * w:(i + 1) * w].contiguous())
                    for i in range(n)]


def merged(q, shards, pos, window, page_size):
    """Each shard attended with its own length, merged by LSE over the
    stacked shards."""
    parts = [tattn.attend_slot_shard(q, k, v, (pos + 1 - off).int(),
                                     window, page_size=page_size)
             for off, k, v in shards]
    out = torch.stack([o for o, _ in parts])
    lse = torch.stack([l for _, l in parts])
    return tattn.merge_by_lse(out, lse, lambda t: t.amax(0, keepdim=True),
                              lambda t: t.sum(0, keepdim=True))[0]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("window", [None, 20, 37])
def test_shards_merged_by_lse_match_the_unsharded_plain(n, window):
    """128 slots in pages of 8; pos at the first slot, inside the first
    shard (later shards' lengths <= 0), on shard borders and one either
    side, and at the last slot; a window that crosses shard borders."""
    rng = np.random.default_rng(n)
    S, H, Hk, dh, PS = 128, 8, 2, 32, 8
    width = S // n
    pos = torch.tensor(sorted({0, 5, width - 1, width, width + 1,
                               2 * width + 3, S - 2, S - 1}))
    B = pos.numel()
    q = torch.from_numpy(rng.normal(size=(B, H, dh)).astype(np.float32))
    ck, cv, shards = slot_shards(rng, B, S, Hk, dh, n)
    got = merged(q, shards, pos, window, PS)
    table = tattn.identity_pages(B, S, PS, "cpu")
    want = kpaged.paged_attention_plain(
        q, ck.reshape(-1, PS, Hk, dh), cv.reshape(-1, PS, Hk, dh), table,
        (pos + 1).int(), window)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= MERGE_TOL * float(
        want.abs().max())


def test_merge_of_all_empty_shards_is_zero():
    out = torch.randn(4, 2, 3, 16)
    lse = torch.full((4, 2, 3), -math.inf)
    lse[0, 1] = 0.5  # sequence 1 has one live shard
    got = tattn.merge_by_lse(out, lse, lambda t: t.amax(0, keepdim=True),
                             lambda t: t.sum(0, keepdim=True))[0]
    assert not torch.isnan(got).any()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.allclose(got[1], out[0, 1], rtol=0, atol=1e-7)


def jax_pair(arch):
    """(config, JAX layer-0 attention params, the port's) in fp32."""
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_build_model(jcfg).init_params(
                          jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    return (cfg, jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"]),
            lm.layers[0].attn)


def gap(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.numpy() - j).max()) / float(np.abs(j).max())


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "starcoder2-15b"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_decode_step_matches_jax_attn_decode(arch, n):
    """A decode step over 128 slots cut into n slot shards: the new key
    and value written at pos, each shard attended with its own length,
    the shards merged by LSE, then wo; StarCoder2's window of 64 crosses
    the shard borders."""
    cfg, jp, tp = jax_pair(arch)
    rng = np.random.default_rng(len(arch) + n)
    S, PS = 128, 16
    pos = np.array([3, 40, 64, 100, 127])
    B = pos.size
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jy, jc = jattn.attn_decode(jp, jnp.asarray(x),
                               {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                               cfg, pos=jnp.asarray(pos, jnp.int32))
    tpos = torch.from_numpy(pos)
    q, k_new, v_new = tattn._project_qkv(tp, torch.from_numpy(x), cfg)
    q = apply_rope(q, tpos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, tpos[:, None], cfg.rope_theta)
    ck, cv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    rows = torch.arange(B)
    ck[rows, tpos], cv[rows, tpos] = k_new[:, 0], v_new[:, 0]
    width = S // n
    shards = [(i * width, ck[:, i * width:(i + 1) * width].contiguous(),
               cv[:, i * width:(i + 1) * width].contiguous())
              for i in range(n)]
    out = merged(q[:, 0].contiguous(), shards, tpos, cfg.sliding_window, PS)
    y = torch.matmul(out.reshape(B, 1, -1), tp["wo"])
    assert gap(y, jy) <= JAX_TOL
    assert gap(ck, jc["k"]) <= JAX_TOL and gap(cv, jc["v"]) <= JAX_TOL


def test_meta_charges_the_lse_store():
    B, H, Hk, dh, PS, MAXP = 4, 8, 2, 64, 16, 32
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(
        s, dtype=dtype, device="meta")
    args = (meta(B, H, dh), meta(B * MAXP, PS, Hk, dh),
            meta(B * MAXP, PS, Hk, dh), meta(B, MAXP, dtype=torch.int32),
            meta(B, dtype=torch.int32))
    plain, _ = roofline.count_costs(kpaged.paged_attention, *args)
    with_lse, (out, lse) = roofline.count_costs(
        lambda *a: kpaged.paged_attention(*a, return_lse=True), *args)
    assert tuple(lse.shape) == (B, H) and lse.dtype == torch.float32
    assert out.shape == args[0].shape
    assert with_lse.bytes_accessed - plain.bytes_accessed == 4 * B * H
    assert with_lse.flops == plain.flops


def test_slot_sharded_decode_counts_the_kernel_alone():
    """The ``kv_seqshard`` decode of CodeQwen1.5-7B ``reduced()`` on a
    (2, 4) mesh: one ``paged_attention`` charge a layer, over the
    shard's slots, and none of the plain path's ops over the cache."""
    cfg = get_arch("codeqwen1.5-7b").reduced()
    mesh = MeshSpec(("data", "model"), (2, 4))
    shape = ShapeCfg("decode_small", "decode", 64, 4)
    with device_mesh(mesh):
        low, _ = steps.lower_cell(cfg, shape, mesh,
                                  variants=frozenset({"kv_seqshard"}))
        costs, _ = roofline.count_costs(low.fn, *low.args)
    assert costs.kernels["paged_attention"]["calls"] == cfg.n_layers
    slots = 64 // 4
    want = roofline.paged_work([slots] * 2, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, tattn.PAGE_SIZE, lse=True)
    assert costs.kernels["paged_attention"]["bytes"] == \
        cfg.n_layers * want.bytes
    assert not {"bmm", "masked_fill", "einsum"} & set(costs.by_op)
