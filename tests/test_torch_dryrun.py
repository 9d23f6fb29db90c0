"""The port's dry run (``launch.steps``' dry-run half, ``launch.dryrun``,
``analysis.roofline``) against the JAX package's, on the CPU.

* Specs: ``input_specs`` gives ``meta`` tensors of the shapes and dtypes
  of JAX's ``ShapeDtypeStruct``s for every applicable cell, exactly.
* Variants: ``moe_sorted`` and ``cf1`` give JAX's config; ``scores_bf16``
  changes nothing the port computes (its kernels keep scores in fp32
  registers), and the port's fp32 logits stay within the bf16 tolerance
  (3e-2, ``test_torch_model.py``'s) of JAX's under ``SCORE_DTYPE = bf16``.
* Argument bytes on the (1, 1) mesh at Qwen2-0.5B ``reduced()``: equal to
  JAX's ``memory_analysis().argument_size_in_bytes`` for a train and a
  decode cell, exactly; a prefill cell differs by the labels alone,
  which XLA drops as an unused argument.
* Counts: the step at L layers less the step at L - 1 equals one body of
  ``group_probes`` within 1%; ``useful_flops_ratio`` within 0.85-1.15 of
  a train cell where attention is small; the kernels' work formulas give
  ``PERF.md``'s bounds; ``table`` gives JAX's string.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.analysis import roofline as jroof
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as jsteps
from repro.launch.mesh import make_smoke_mesh as jax_smoke_mesh
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.analysis import roofline
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import SHAPES, ShapeCfg, shape_applicable
from repro_torch.convert import lm_params_from_arrays
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (device_mesh, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import LM

CELLS = [(a, s) for a in all_archs() for s in SHAPES
         if shape_applicable(get_arch(a), SHAPES[s])[0]]
LOGIT_BF16_TOL = 3e-2
PROBE_TOL = 0.01
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int8): torch.int8}


def shapes_of(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)]),
                        tree)


def test_32_of_40_cells_apply():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    """Every input of the cell: shape and dtype as JAX's stand-ins."""
    jcfg = jax_get_arch(arch)
    want = shapes_of(jsteps.input_specs(jcfg, JAX_SHAPES[shape]))
    got = jax.tree.map(lambda t: (tuple(t.shape), t.dtype),
                       steps.input_specs(get_arch(arch), SHAPES[shape]))
    assert got == want
    for t in jax.tree.leaves(steps.input_specs(get_arch(arch),
                                               SHAPES[shape])):
        assert t.device.type == "meta"


def test_apply_variants_match_jax():
    """``moe_sorted`` and ``cf1`` as JAX's ``dataclasses.replace``; the
    JAX call's ``SCORE_DTYPE`` global is reset afterwards."""
    try:
        for arch in ("mixtral-8x22b", "deepseek-moe-16b", "qwen2-0.5b"):
            for v in ({"moe_sorted"}, {"cf1"}, {"moe_sorted", "cf1"},
                      {"scores_bf16", "kv_int8", "dp_only"}):
                want = jsteps.apply_variants(jax_get_arch(arch),
                                             frozenset(v))
                got = steps.apply_variants(get_arch(arch), frozenset(v))
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    finally:
        jsteps.apply_variants(jax_get_arch("qwen2-0.5b"), frozenset())
    assert jattn.SCORE_DTYPE is None


def test_scores_bf16_is_within_bf16_of_jax():
    """JAX's ``scores_bf16`` rounds the [T, T] scores to bf16; the port's
    kernels keep them in fp32, so its logits are those without the
    variant, within the bf16 tolerance of JAX's with it."""
    cfg, jcfg = get_arch("qwen2-0.5b").reduced(), \
        jax_get_arch("qwen2-0.5b").reduced()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 40))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    try:
        jsteps.apply_variants(jcfg, frozenset({"scores_bf16"}))
        jl_bf16 = np.asarray(jm.forward(jp, batch)[0], np.float32)
    finally:
        jsteps.apply_variants(jcfg, frozenset())
    jl = np.asarray(jm.forward(jp, batch)[0], np.float32)
    assert np.abs(jl_bf16 - jl).max() > 0  # the variant takes effect in JAX
    cfg_v = steps.apply_variants(cfg, frozenset({"scores_bf16"}))
    assert cfg_v == cfg
    with torch.no_grad():
        tl = lm.forward({"tokens": torch.from_numpy(toks)})[0].numpy()
    assert np.abs(tl - jl_bf16).max() < LOGIT_BF16_TOL
    assert np.abs(tl - jl).max() < 1e-4


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_argument_bytes_equal_jax_memory_analysis(kind):
    cfg, jcfg = get_arch("qwen2-0.5b").reduced(), \
        jax_get_arch("qwen2-0.5b").reduced()
    shape = ShapeCfg(f"{kind}_small", kind, 64, 4)
    lowered, _ = jsteps.lower_cell(jcfg, shape, jax_smoke_mesh())
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    mesh = make_smoke_mesh()
    low, _ = steps.lower_cell(cfg, shape, mesh)
    got = dryrun.argument_bytes(low.arg_specs, low.shardings, mesh)
    if kind == "prefill":
        # XLA prunes the prefill step's unused argument, the labels
        labels = low.arg_specs["batch"]["labels"]
        assert got - want == labels.numel() * labels.element_size()
    else:
        assert got == want


def test_sharded_argument_bytes_divide_by_the_axes():
    """On the pod mesh each sharded dimension is divided by its axes:
    decode_32k's caches over data (32) and, where 2 kv heads do not
    divide 8, not over model."""
    cfg = get_arch("qwen2-0.5b")
    mesh = make_production_mesh()
    with device_mesh(mesh):
        low, _ = steps.lower_cell(cfg, SHAPES["decode_32k"], mesh)
    caches = low.arg_specs["caches"]["blocks"]["l0"]["k"]
    spec = low.shardings["caches"]["blocks"]["l0"]["k"]
    assert spec == (None, "data", None, None, None)
    got = dryrun.argument_bytes({"c": caches}, {"c": spec}, mesh)
    assert got == caches.numel() * 2 // 32


def counted_flops(cfg, shape, remat="full"):
    low, _ = steps.lower_cell(cfg, shape, make_smoke_mesh(), remat=remat)
    return roofline.count_costs(low.fn, *low.args)[0].flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_equals_one_more_layer(kind):
    """The counterpart of ``test_scan_correction_matches_unrolled``: the
    step at L layers less the step at L - 1 is one body, as
    ``group_probes`` gives it, within 1%; the body runs without remat, as
    the JAX package's probes do, so the steps are counted under
    ``remat="none"``."""
    base = get_arch("qwen2-0.5b").reduced()
    shape = ShapeCfg(f"{kind}_small", kind, 64, 4)
    L = dataclasses.replace(base, n_layers=3)
    diff = counted_flops(L, shape, "none") - counted_flops(
        dataclasses.replace(base, n_layers=2), shape, "none")
    (group, repeat, probe), = steps.group_probes(L, shape, make_smoke_mesh())
    assert (group, repeat) == ("blocks", 3)
    body = roofline.count_costs(probe.fn, *probe.args)[0].flops
    assert abs(diff - body) <= PROBE_TOL * body, (diff, body)


def test_useful_ratio_of_a_train_cell_near_one():
    """6 N D over the count: near one without remat; under the default
    ``"full"`` the recomputed forward (some 2 N D more) takes it near
    6/8."""
    cfg = get_arch("qwen2-0.5b").reduced()
    shape = ShapeCfg("train_small", "train", 64, 4)
    useful = {}
    for remat in ("none", "full"):
        low, _ = steps.lower_cell(cfg, shape, make_smoke_mesh(), remat=remat)
        costs, _ = roofline.count_costs(low.fn, *low.args)
        rec = roofline.cell_costs(cfg, shape, costs, [])
        useful[remat] = rec["useful_flops_ratio"]
        assert rec["terms_ms"]["collective"] == 0.0
        assert set(rec["kernels"]) == {"flash_attention",
                                       "flash_attention_bwd"}
    assert 0.85 < useful["none"] < 1.15
    assert 0.7 < useful["full"] < 0.85


def test_formulas_give_perf_md_bounds():
    """PERF.md section 6's bounds, from the moved formulas: row 8 at
    Qwen2-0.5B's len 529 and StarCoder2's window of 4096 (8,414,212 B),
    rows 10b and 11b at their training shapes, row 9 windowed."""
    ms = lambda w: roofline.bound(w.bytes, w.flops)  # noqa: E731
    w = roofline.paged_work([529], 14, 2, 64, 16)
    assert w.bytes == 274572 and round(ms(w)[0], 7) == 0.0000820
    w = roofline.paged_work([4096], 48, 4, 128, 16)
    assert w.bytes == 8414212 and round(ms(w)[0], 7) == 0.0025117
    assert round(ms(roofline.ssd_bwd_work(1, 4096, 256, 64, 16))[0], 6) == \
        0.122856
    assert round(ms(roofline.wkv6_bwd_work(8, 256, 64, 64))[0], 6) == \
        0.055099
    w = roofline.flash_work(1, 4352, 4352, 48, 4, 128,
                            roofline.seen_pairs(4352, 4352, 4096))
    assert ms(w) == (pytest.approx(0.234559, abs=1e-6), "operations")
    # chip_smoke.py takes its constants and bounds from here
    assert chip_smoke.HBM_BYTES_PER_S == roofline.HBM_BW == 3.35e12
    assert chip_smoke.BF16_FLOPS_PER_S == roofline.PEAK_FLOPS == 989e12
    assert chip_smoke.LANE_OPS_PER_S == roofline.LANE_OPS == 67e12
    assert chip_smoke.work_bound(w) == ms(w)


def test_table_is_jax_string(tmp_path):
    recs = [dryrun.run_cell("qwen2-0.5b", s, make_smoke_mesh(),
                            out_dir=str(tmp_path), probes=False)
            for s in ("decode_32k", "prefill_32k")]
    loaded = roofline.load_records(str(tmp_path))
    assert len(loaded) == 2 and loaded[0]["mesh"] == "1x1"
    assert roofline.table(loaded) == jroof.table(loaded, mesh="1x1")
    assert "qwen2-0.5b | decode_32k" in roofline.table(recs)
    assert dryrun.summary(loaded).splitlines()[2].startswith(
        "| qwen2-0.5b | - | ")


def test_pod_record_has_specs_and_no_roofline(tmp_path):
    """The 32 x 8 record: its specs and fallbacks, and the roofline of
    one device's share, whose collective term is above 0."""
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", make_production_mesh(),
                          out_dir=str(tmp_path))
    rl = rec["roofline"]
    assert "why" not in rec and rl["terms_ms"]["collective"] > 0
    assert rl["collective_mb"] == pytest.approx(
        sum(rl["collective_by_axis_mb"].values()))
    assert set(rl["collective_by_axis_mb"]) <= {"data", "model"}
    assert rec["memory"]["temp_bytes"] > 0 and "fits_80gb" in rec
    assert rec["n_devices"] == 256 and rec["memory"]["argument_bytes"] > 0
    assert "embed: dim 0 (model)" in rec["replicated"]
    on_disk = json.load(open(tmp_path / "whisper-tiny__decode_32k__32x8.json"))
    assert on_disk["memory"] == rec["memory"]
    assert on_disk["specs"]["params"]["embed"] == [None, None]
    assert rec["specs"]["caches"]["blocks"]["l0"]["k"] == \
        (None, "data", None, None, None)
    skipped = dryrun.run_cell("qwen2-0.5b", "long_500k", make_smoke_mesh(),
                              out_dir=str(tmp_path))
    assert "skipped" in skipped


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_traces_on_meta_at_reduced(arch, shape):
    """Each applicable cell's step and probes run on ``meta`` at the
    config's ``reduced()`` (the cell's shape cut 64-fold in length and
    batch), every model kernel charged and none launched."""
    full = SHAPES[shape]
    cut = dataclasses.replace(full, seq_len=max(1, full.seq_len // 64),
                              global_batch=max(1, full.global_batch // 64))
    cfg = get_arch(arch).reduced()
    if cfg.vision is not None and cut.kind != "decode":
        cut = dataclasses.replace(cut, seq_len=cfg.vision.n_patches + 8)
    low, _ = steps.lower_cell(cfg, cut, make_smoke_mesh())
    costs, _ = roofline.count_costs(low.fn, *low.args)
    assert costs.flops > 0 and costs.bytes_accessed > 0 and costs.kernels
    for _, _, probe in steps.group_probes(cfg, cut, make_smoke_mesh()):
        assert roofline.count_costs(probe.fn, *probe.args)[0].flops > 0


def test_meta_only_when_asked():
    """``meta`` is never a default or a fallback."""
    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    cfg = get_arch("qwen2-0.5b")
    lm = LM(cfg, device="meta")
    assert lm.embed.device.type == "meta"
    # the config's analytic count leaves out the final norm
    assert cfg.param_count() == 494_031_872
    assert sum(p.numel() for p in lm.parameters()) == \
        494_031_872 + cfg.d_model
