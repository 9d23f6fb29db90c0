"""The port's partitioner on the CPU: DTensor over a ``fake`` process
group (``launch.mesh.device_mesh``) as the production meshes' per-device
program, against hand counts, the one-card count, the JAX dry run's
partitioned program and a real 4-process run.

* (a) Hand-built cases on a fake (2, 4) mesh on ``meta``, exact: a
  column- then row-parallel MLP counts one all-reduce over "model" of
  [B/2, T, D] bf16; a replicated weight's gradient is all-reduced over
  "data"; an all-gather is charged its gathered bytes (the JAX parser's
  convention, ``tests/test_roofline.py``).
* (b) On the one-card mesh the count is the seed's, FLOPs, bytes and
  lane operations bit for bit (the numbers below were counted on the
  tree before the partitioner, which had no remat: they are the
  ``remat="none"`` step's), for five families; the train step under the
  default ``"full"`` has its own rows, counted when remat came in.  The
  temp bytes are the count's by storage (each storage live from the op
  that makes it until it is freed, whatever aliases hold it), counted
  when that replaced the count by tensor object.
* (c) CodeQwen1.5-7B ``reduced()`` at (2, 4), where no rule falls back:
  per-device FLOPs times 8 equal the one-card FLOPs within 1e-9
  (relative).
* (d) A subprocess with 8 fake XLA host devices runs the JAX package's
  ``lower_cell`` and ``cell_costs`` at (2, 4) and at (1, 1) for a train
  and a decode cell of CodeQwen1.5-7B ``reduced()`` widened to d_model
  1024, d_ff 2048 and 8 heads of 128 (at d_model 128 XLA's count of the
  replicated elementwise work, which the port counts as bytes, is 6% of
  a device's FLOPs), the train cell under each remat policy.  Per-device
  argument bytes equal JAX's ``memory_analysis()`` exactly.  The train
  cell's FLOP share (mesh over one card) is within 5% of JAX's.  The
  decode cell's is exactly 1/8 in the port; XLA's CPU backend computes
  bf16 products in fp32 and counts each ``convert`` of an operand as a
  FLOP, and the weights it converts are sharded over "model" only, so
  its share is 0.15381: XLA's FLOPs less its converts' divide by 8
  within 5% (PERF.md).  The one-card train FLOPs match JAX's within 1%
  under each policy, once JAX's count is given the recomputes its scan
  correction leaves out (``cell_costs`` adds ``repeat - 1`` probes of
  the body without remat, so it counts one body's recompute: the
  correction adds ``repeat - 1`` times the program's FLOPs under the
  policy less under ``"none"``).  Temp bytes: JAX's are full < dots <
  none on both meshes; the port's, counted by storage, are equal under
  the three policies, as the card's peak memory reads them at
  MiniCPM-2B's one-card training step (PERF.md, F3): at these cells
  the step peaks where the gradients and AdamW's temporaries are live,
  after every region's activations are freed, whatever the policy
  saved; where the activations dominate (T = 512) the port's order is
  JAX's.  The total collective bytes are within
  a factor of 2 of JAX's (measured: 1.59 train, 2.0 decode); the port's
  reduce-scatter (the ZeRO step's) and XLA's all-to-all are each present
  in one alone (PERF.md).  InternVL2-76B's ``reduced()`` widened alike
  has a train cell of 8 sequences of 256 (``WIDE_TRAIN``), whose
  per-device FLOP share is within 5% of JAX's: where its projected
  patches put the residual stream on D's shards (F4) DTensor gathers
  whole weights there and the share misses.
* (e) Four ``gloo`` processes on a (2, 2) mesh against the unsharded
  port in one process, fp32: a prefill's logits within 1e-5 of the
  largest; one decode step's logits and caches (each leaf within 1e-5
  of its largest), with the caches sharded by batch, as ``long_500k``'s
  by slot over the data axes and as ``kv_seqshard``'s by slot over
  "model" (each shard attended by the paged kernel's plain version and
  the shards merged by log-sum-exp over real all-reduces); and one train
  step's updated parameters within 1e-6 of the
  model's largest parameter and its first moments within 1e-4 of each
  leaf's largest (one AdamW step moves an element by up to the learning
  rate, 3e-6 here, ten times that limit; a gradient summed over one data
  shard alone misses the moments' limit), for CodeQwen1.5-7B and, for
  their own partitioning (MoE dispatch, the scans' local maps), the MoE,
  RWKV6 and hybrid families, and InternVL2-76B (its patches placed as
  the text, F4) and Qwen2-0.5B (one kv head over a "model" of 2: the
  heads fall back to replication and reach ``wo`` sliced, F5), each
  ``reduced()``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.analysis import roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (MeshSpec, device_mesh,
                                     make_production_mesh, make_smoke_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = MeshSpec(("data", "model"), (2, 4))
META = torch.device("meta")
SHARE_TOL = 1e-9
JAX_SHARE_TOL = 0.05
JAX_FLOP_TOL = 0.01
COLL_FACTOR = 2.0
LOGIT_TOL = 1e-5
PARAM_TOL = 1e-6
MOMENT_TOL = 1e-4
WIDE = dict(d_model=1024, d_ff=2048, n_heads=8, n_kv_heads=8, d_head=128)
WIDE_ARCHS = ["internvl2-76b"]  # (d)'s train cell beside CodeQwen1.5-7B's
WIDE_TRAIN = (256, 8)  # its T and B


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


# -- (a) hand-built cases ----------------------------------------------------

def test_megatron_mlp_counts_one_all_reduce_over_model():
    B, T, D, F = 4, 8, 64, 256
    with device_mesh(MESH) as dm:
        x = steps.place(meta(B, T, D), ("data", None, None), dm)
        w1 = steps.place(meta(D, F), (None, "model"), dm)
        w2 = steps.place(meta(F, D), ("model", None), dm)

        def mlp(x, w1, w2):
            return torch.matmul(torch.matmul(x, w1), w2).redistribute(
                dm, x.placements)

        costs, y = roofline.count_costs(steps.spmd(mlp), x, w1, w2)
        assert y.placements == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (B // 2, T, D)
    one = B // 2 * T * D * 2
    assert costs.coll_by_kind == {"all-reduce": one}
    assert costs.coll_by_axis == {"model": one}
    assert costs.flops == 2 * 2 * (B // 2) * T * D * (F // 4)


def test_replicated_weight_gradient_is_reduced_over_data():
    B, D = 8, 32
    with device_mesh(MESH) as dm:
        x = steps.place(meta(B, D, dtype=torch.float32), ("data", None), dm)
        w = steps.place(meta(D, D, dtype=torch.float32), (None, None), dm)
        w.requires_grad_(True)

        def grad(x, w):
            torch.matmul(x, w).sum().backward()
            assert w.grad.placements[0].is_partial()
            return w.grad.redistribute(dm, (Replicate(), Replicate()))

        costs, g = roofline.count_costs(steps.spmd(grad), x, w)
    assert tuple(g.to_local().shape) == (D, D)
    assert costs.coll_by_axis.get("data") == D * D * 4
    assert costs.coll_by_kind.get("all-reduce", 0) >= D * D * 4


def test_all_gather_is_charged_its_gathered_bytes():
    with device_mesh(MESH) as dm:
        t = steps.place(meta(8, 16), ("data", None), dm)
        costs, out = roofline.count_costs(
            lambda t: t.redistribute(dm, (Replicate(), Replicate())), t)
    assert tuple(out.to_local().shape) == (8, 16)
    assert costs.coll_by_kind == {"all-gather": 8 * 16 * 2}
    assert costs.coll_by_axis == {"data": 8 * 16 * 2}
    assert costs.bytes_accessed == 0  # a collective is no HBM traffic


def test_device_mesh_leaves_no_group_and_counts_both_meshes():
    for mesh in (make_production_mesh(multi_pod=True),
                 make_production_mesh()):
        with device_mesh(mesh) as dm:
            assert dist.get_world_size() == mesh.size
            assert tuple(dm.mesh.shape) == mesh.sizes
            assert dm.get_rank() == 0
        assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="inside device_mesh"):
        steps.lower_cell(get_arch("qwen2-0.5b").reduced(),
                         ShapeCfg("d", "decode", 64, 4),
                         make_production_mesh())


def test_placements_follow_the_spec():
    with device_mesh(make_production_mesh(multi_pod=True)) as dm:
        assert sharding.placements((("pod", "data"), None, "model"), dm) == \
            (Shard(0), Shard(0), Shard(2))
        assert sharding.placements((None, None), dm) == \
            (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            sharding.placements((("data", "pod"),), dm)


def test_batch_falls_back_to_the_axes_that_divide_it():
    """prefill_32k's 32 sequences over ("pod", "data") = 64 devices shard
    over "data" alone; dividing specs are unchanged."""
    mesh = make_production_mesh(multi_pod=True)
    assert sharding.fit_spec((32, 8), (("pod", "data"), None), mesh) == \
        ("data", None)
    assert sharding.fit_spec((128, 8), (("pod", "data"), None), mesh) == \
        (("pod", "data"), None)
    assert sharding.local_shape((32, 8), (("pod", "data"), None),
                                mesh) == (1, 8)


# -- (b) the one-card count is the seed's ------------------------------------

SEED_COUNTS = [  # (arch, kind, FLOPs, bytes, lane ops, temp bytes)
    ("qwen2-0.5b", "train", 558301184.0, 120404714.0, 0.0, 5684232),
    ("qwen2-0.5b", "prefill", 151650304.0, 15713376.0, 0.0, 917504),
    ("qwen2-0.5b", "decode", 3014656.0, 1030576.0, 0.0, 13424),
    ("codeqwen1.5-7b", "train", 633798656.0, 147111166.0, 0.0, 5880840),
    ("codeqwen1.5-7b", "prefill", 176816128.0, 19353696.0, 0.0, 1114112),
    ("codeqwen1.5-7b", "decode", 3407872.0, 1380784.0, 0.0, 13424),
    ("deepseek-moe-16b", "train", 2480078848.0, 262318134.0, 0.0, 20559876),
    ("deepseek-moe-16b", "prefill", 885915648.0, 83157356.0, 0.0, 15331328),
    ("deepseek-moe-16b", "decode", 6100992.0, 1606988.0, 0.0, 65584),
    ("rwkv6-7b", "train", 650117120.0, 156640078.0, 8388608.0, 7287816),
    ("rwkv6-7b", "prefill", 168296448.0, 20801120.0, 8388608.0, 1050624),
    ("rwkv6-7b", "decode", 3145728.0, 1670176.0, 131072.0, 144928),
    ("jamba-1.5-large-398b", "train", 9853698048.0, 1011590198.0,
     14680064.0, 64789092),
    ("jamba-1.5-large-398b", "prefill", 3588816896.0, 343155856.0,
     14680064.0, 16291840),
    ("jamba-1.5-large-398b", "decode", 23166976.0, 6251728.0, 229376.0,
     352304),
]


FULL_REMAT_COUNTS = [  # the train step under remat="full", as above
    ("qwen2-0.5b", 675872768.0, 134786282.0, 0.0, 3083276),
    ("codeqwen1.5-7b", 776536064.0, 164739838.0, 0.0, 3083276),
    ("deepseek-moe-16b", 3348692992.0, 344536822.0, 0.0, 19358224),
    ("rwkv6-7b", 817889280.0, 176093006.0, 16777216.0, 3189516),
    ("jamba-1.5-large-398b", 13374881792.0, 1349958966.0, 29360128.0,
     22480960),
]


def one_card(cfg, kind, remat="full"):
    low, _ = steps.lower_cell(cfg, ShapeCfg(f"{kind}_small", kind, 64, 4),
                              make_smoke_mesh(), remat=remat)
    return roofline.count_costs(low.fn, *low.args)[0]


@pytest.mark.parametrize("arch,kind,flops,n_bytes,lane_ops,temp",
                         SEED_COUNTS)
def test_one_card_count_is_unchanged(arch, kind, flops, n_bytes, lane_ops,
                                     temp):
    c = one_card(get_arch(arch).reduced(), kind, remat="none")
    assert (c.flops, c.bytes_accessed, c.lane_ops, c.temp_bytes) == \
        (flops, n_bytes, lane_ops, temp)
    assert c.coll_by_kind == {} and c.collective_s() == 0.0


@pytest.mark.parametrize("arch,flops,n_bytes,lane_ops,temp",
                         FULL_REMAT_COUNTS)
def test_one_card_full_remat_count(arch, flops, n_bytes, lane_ops, temp):
    """Under the default ``"full"`` the train step recomputes each
    region's forward: more FLOPs, bytes and (scans) lane operations than
    ``"none"``, fewer temp bytes."""
    c = one_card(get_arch(arch).reduced(), "train")
    assert (c.flops, c.bytes_accessed, c.lane_ops, c.temp_bytes) == \
        (flops, n_bytes, lane_ops, temp)
    none = next(r for r in SEED_COUNTS if r[:2] == (arch, "train"))
    assert c.flops > none[2] and c.bytes_accessed > none[3]
    assert c.temp_bytes < none[5]


# -- (c) per-device FLOPs divide by the mesh --------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_per_device_flops_are_an_eighth(kind):
    cfg = get_arch("codeqwen1.5-7b").reduced()
    shape = ShapeCfg(f"{kind}_small", kind, 64, 4)
    with device_mesh(MESH):
        low, _ = steps.lower_cell(cfg, shape, MESH)
        assert sharding.replicated(low.arg_specs["params"], MESH) == []
        costs, _ = roofline.count_costs(low.fn, *low.args)
    card = one_card(cfg, kind).flops
    assert abs(costs.flops * MESH.size - card) <= SHARE_TOL * card
    assert costs.coll_by_axis["model"] > 0


# -- (d) against the JAX package's partitioned program ----------------------

JAX_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, json, re, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.analysis import roofline
    from repro.configs import get_arch
    from repro.configs.base import ShapeCfg
    from repro.launch import steps
    from repro.models.model import LM

    def convert_flops(text):
        # XLA's CPU backend upcasts bf16 operands: one FLOP an element
        shapes = re.findall(r"= \\w+\\[([\\d,]*)\\]\\S* convert\\(", text)
        return sum(int(np.prod([int(d) for d in dims.split(",") if d]))
                   for dims in shapes)

    cfg = dataclasses.replace(get_arch("codeqwen1.5-7b").reduced(),
                              **json.loads(sys.argv[1]))
    devs = np.array(jax.devices())
    meshes = {"mesh": Mesh(devs.reshape(2, 4), ("data", "model")),
              "card": Mesh(devs[:1].reshape(1, 1), ("data", "model"))}
    out = {}
    one = dataclasses.replace(cfg, n_layers=1)
    for kind, policies, c in (("train", ("full", "dots", "none"), cfg),
                              ("decode", ("full",), cfg),
                              ("decode1", ("full",), one)):
        shape = ShapeCfg(f"{kind}_small", kind[:6], 64, 4)
        for policy in policies:
            steps.build_model = lambda c, _p=policy: LM(c, remat=_p)
            for name, mesh in meshes.items():
                lowered, _ = steps.lower_cell(c, shape, mesh)
                compiled = lowered.compile()
                probes = steps.group_probes(c, shape, mesh)
                rec = roofline.cell_costs(c, shape, lowered, compiled,
                                          probes, mesh)
                mem = compiled.memory_analysis()
                key = ".".join([kind, name] + ([policy] * (policy != "full")))
                out[key] = {
                    "argument_bytes": mem.argument_size_in_bytes,
                    "temp_bytes": mem.temp_size_in_bytes,
                    "gflops": rec["hlo_gflops"],
                    "base_gflops": roofline.costs_of(compiled).flops / 1e9,
                    "extra_reps": sum(r for _, r, _ in probes),
                    "collective_by_kind_mb": rec["collective_by_kind_mb"]}
                if kind.startswith("decode"):
                    out[key]["convert_gflops"] = (
                        convert_flops(compiled.as_text()) + sum(
                            r * convert_flops(p.compile().as_text())
                            for _, r, p in probes)) / 1e9
    # the other architectures' reduced() configs, widened alike: a
    # train cell of their own under the default policy, on both meshes
    steps.build_model = lambda c: LM(c, remat="full")
    more = json.loads(sys.argv[2])
    shape = ShapeCfg("train_wide", "train", *more["shape"])
    for arch in more["archs"]:
        c = dataclasses.replace(get_arch(arch).reduced(),
                                **json.loads(sys.argv[1]))
        for name, mesh in meshes.items():
            lowered, _ = steps.lower_cell(c, shape, mesh)
            compiled = lowered.compile()
            probes = steps.group_probes(c, shape, mesh)
            rec = roofline.cell_costs(c, shape, lowered, compiled, probes,
                                      mesh)
            out[f"{arch}.train.{name}"] = {"gflops": rec["hlo_gflops"]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", JAX_CELLS, json.dumps(WIDE),
                           json.dumps({"archs": WIDE_ARCHS,
                                       "shape": WIDE_TRAIN})],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def wide_cfg(arch="codeqwen1.5-7b"):
    return dataclasses.replace(get_arch(arch).reduced(), **WIDE)


def port_cell(kind, remat="full", cfg=None):
    cfg = cfg or wide_cfg()
    shape = ShapeCfg(f"{kind}_small", kind, 64, 4)
    with device_mesh(MESH):
        low, _ = steps.lower_cell(cfg, shape, MESH, remat=remat)
        costs, _ = roofline.count_costs(low.fn, *low.args)
        args = dryrun.argument_bytes(low.arg_specs, low.shardings, MESH)
    return args, costs, one_card(cfg, kind, remat)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_per_device_program_against_jax(jax_cells, kind):
    args, costs, card = port_cell(kind)
    jm, jc = jax_cells[f"{kind}.mesh"], jax_cells[f"{kind}.card"]
    assert args == jm["argument_bytes"]
    share, jshare = costs.flops / card.flops, jm["gflops"] / jc["gflops"]
    assert share == 1 / MESH.size
    if kind == "train":
        assert abs(share - jshare) <= JAX_SHARE_TOL * jshare, (share, jshare)
    else:  # XLA's converts of the weights divide by "model" alone
        assert jshare > share * (1 + JAX_SHARE_TOL), jshare
        dots = ((jm["gflops"] - jm["convert_gflops"])
                / (jc["gflops"] - jc["convert_gflops"]))
        assert abs(dots - share) <= JAX_SHARE_TOL * share, (dots, share)
    jkinds = jm["collective_by_kind_mb"]
    port = {k: v / 1e6 for k, v in costs.coll_by_kind.items()}
    ratio = sum(jkinds.values()) / sum(port.values())
    assert 1 / COLL_FACTOR <= ratio <= COLL_FACTOR, (port, jkinds)
    only = set(port) ^ set(jkinds)
    assert only <= {"reduce-scatter", "all-to-all"}, only


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_per_device_train_flops_against_jax(jax_cells, arch):
    """InternVL2-76B's train cell, widened as CodeQwen1.5-7B's, at 8
    sequences of 256: its projected patches are placed as the text
    before they join it, so each device runs its share of every product,
    as XLA's partitioned program does.  With the residual stream sharded
    on D DTensor gathered the weights of the products and the share read
    0.1450 (at 4 sequences of 64 it gathered the activations instead, and
    the share was 1/8 within 0.1%)."""
    cfg = wide_cfg(arch)
    shape = ShapeCfg("train_wide", "train", *WIDE_TRAIN)
    with device_mesh(MESH):
        low, _ = steps.lower_cell(cfg, shape, MESH)
        costs, _ = roofline.count_costs(low.fn, *low.args)
    low, _ = steps.lower_cell(cfg, shape, make_smoke_mesh())
    card = roofline.count_costs(low.fn, *low.args)[0]
    jm, jc = (jax_cells[f"{arch}.train.{m}"] for m in ("mesh", "card"))
    share, jshare = costs.flops / card.flops, jm["gflops"] / jc["gflops"]
    assert abs(share - jshare) <= JAX_SHARE_TOL * jshare, (share, jshare)


def r11_products(cfg, tokens):
    """The FLOPs a device adds where the JAX package's ``param_specs``
    replicate a layer's column-parallel weights (R11: at one layer the
    unstacked ``blocks`` group is given the stacked specs): each product
    of the ``tokens`` a device holds with a weight the port shards on its
    output over "model" ((None, "model")), run at full width instead of
    a 1/model share."""
    model = MESH.sizes[MESH.axis_names.index("model")]
    specs = steps.lm_specs(steps.meta_model(cfg), MESH)
    return sum(2 * tokens * p.shape[0] * p.shape[1] * (1 - 1 / model)
               for n, p in steps.meta_model(cfg).named_parameters()
               if n.startswith("layers.") and p.dim() == 2
               and tuple(specs[n]) == (None, "model"))


def test_one_layer_decode_share_against_jax_with_r11(jax_cells):
    """At one layer XLA's decode share, less its converts, is the port's
    share once R11's full-width products are added to the port's
    per-device FLOPs, within the 2-layer case's 5%; without them it
    misses (PERF.md, F2)."""
    cfg = dataclasses.replace(wide_cfg(), n_layers=1)
    _, costs, card = port_cell("decode", cfg=cfg)
    jm, jc = jax_cells["decode1.mesh"], jax_cells["decode1.card"]
    dots = ((jm["gflops"] - jm["convert_gflops"])
            / (jc["gflops"] - jc["convert_gflops"]))
    data = MESH.sizes[MESH.axis_names.index("data")]
    extra = r11_products(cfg, 4 // data)
    share = (costs.flops + extra) / card.flops
    assert abs(dots - share) <= JAX_SHARE_TOL * share, (dots, share)
    assert dots > (1 + JAX_SHARE_TOL) * costs.flops / card.flops, dots


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_one_card_train_flops_against_jax_per_policy(jax_cells, policy):
    """JAX's count with its scan's ``repeat - 1`` missing recomputes
    added; under ``"none"`` that is JAX's count itself."""
    suffix = "" if policy == "full" else "." + policy
    j, jn = jax_cells["train.card" + suffix], jax_cells["train.card.none"]
    want = j["gflops"] + j["extra_reps"] * (j["base_gflops"]
                                            - jn["base_gflops"])
    got = one_card(wide_cfg(), "train", policy).flops / 1e9
    assert abs(got - want) <= JAX_FLOP_TOL * want, (got, want, j["gflops"])


def test_temp_bytes_order_per_policy(jax_cells):
    for mesh in ("card", "mesh"):
        jt = [jax_cells[f"train.{mesh}{s}"]["temp_bytes"]
              for s in ("", ".dots", ".none")]
        assert jt[0] < jt[1] < jt[2], (mesh, jt)
    temps = {p: port_cell("train", p) for p in ("full", "dots", "none")}
    for at in (lambda c: c[1].temp_bytes, lambda c: c[2].temp_bytes):
        full, dots, none = (at(temps[p]) for p in ("full", "dots", "none"))
        assert full == dots == none, (full, dots, none)
    # where the activations dominate (T = 512, 8 sequences), JAX's order
    heavy = []
    for policy in ("full", "dots", "none"):
        with device_mesh(MESH):
            low, _ = steps.lower_cell(get_arch("codeqwen1.5-7b").reduced(),
                                      ShapeCfg("train_long", "train", 512,
                                               8), MESH, remat=policy)
            heavy.append(roofline.count_costs(low.fn, *low.args)[0]
                         .temp_bytes)
    assert heavy[0] < heavy[1] < heavy[2], heavy


# -- (e) four gloo processes against the unsharded port ----------------------

WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import LM
    from repro_torch.optim import adamw

    rank, port, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                            rank=rank, world_size=4)
    spec = MeshSpec(("data", "model"), (2, 2))
    dm = init_device_mesh("cpu", spec.sizes, mesh_dim_names=spec.axis_names)
    cfg = get_arch(arch).reduced()

    def fp32_model():
        lm = LM(cfg, seed=0, device="cpu")
        for p in lm.parameters():
            p.data = p.data.float()
        return lm

    def put(t, s):
        s = sharding.fit_spec(tuple(t.shape), s, spec)
        return distribute_tensor(t, dm, sharding.placements(s, dm))

    ref, lm = fp32_model(), fp32_model()
    specs = steps.lm_specs(lm, spec)
    for name, p in list(lm.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(owner) if owner else lm
        new = torch.nn.Parameter(put(p.data, specs[name]),
                                 requires_grad=False)
        if isinstance(mod, torch.nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)
    rng = np.random.default_rng(1)
    B, T = 4, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))).int()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))).int()
    vis = {}  # InternVL's patches lead the text
    if cfg.vision is not None:
        vis["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.vision.n_patches, cfg.vision.d_vit))).float()
    batch = {"tokens": put(tokens, ("data", None)),
             "labels": put(labels, ("data", None)),
             **{k: put(v, ("data", None, None)) for k, v in vis.items()}}
    with torch.no_grad():
        want, _ = ref.prefill({"tokens": tokens, **vis}, T)
        got, _ = steps.spmd(lambda b: lm.prefill(b, T))(
            {k: v for k, v in batch.items() if k != "labels"})
    logit_err = float((got.full_tensor() - want).abs().max()
                      / want.abs().max())
    # one decode step against random caches of 64 slots, the caches
    # sharded by batch, by slot over the data axes as long_500k's, and
    # by slot over "model" as kv_seqshard's (sequences whose pos lies on
    # the other shard read past their shard's table)
    gen = torch.Generator().manual_seed(2)
    caches = ref.init_caches(B, 64)
    for group in caches.values():
        for leaves in group.values():
            for t in leaves.values():
                t.normal_(generator=gen)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (B,))).int()
    pos = torch.tensor([63, 40, 17, 5], dtype=torch.int32)
    clone = lambda tree: {k: clone(v) if isinstance(v, dict) else v.clone()
                          for k, v in tree.items()}
    with torch.no_grad():
        want, want_c = ref.decode_step(token, clone(caches), pos)
    decode_err = 0.0
    for how in ({}, {"seq_shard": True}, {"kv_seq_model": True}):
        cspecs = sharding.cache_specs(caches, spec, **how)
        placed = {g: {l: {n: put(t.clone(), cspecs[g][l][n])
                          for n, t in leaves.items()}
                      for l, leaves in group.items()}
                  for g, group in caches.items()}
        tspec = (None,) if how.get("seq_shard") else ("data",)
        with torch.no_grad():
            got, got_c = steps.spmd(lm.decode_step)(
                put(token, tspec), placed, put(pos, tspec))
        errs = [float((got.full_tensor() - want).abs().max()
                      / want.abs().max())]
        for g, group in want_c.items():
            for l, leaves in group.items():
                for n, t in leaves.items():
                    errs.append(float((got_c[g][l][n].full_tensor() - t)
                                      .abs().max() / t.abs().max()))
        decode_err = max(decode_err, *errs)
    _, st_ref = steps.make_train_step(ref, cfg.name)(
        {"tokens": tokens, "labels": labels, **vis},
        adamw.init(dict(ref.named_parameters())))
    whole = dict(fp32_model().named_parameters())
    zero = sharding.zero_specs(specs, whole, spec)
    st = adamw.AdamWState(
        0, *({n: put(f(whole[n]), zero[n]) for n in specs}
             for f in (torch.zeros_like, torch.zeros_like,
                       lambda t: t.detach().clone())))
    _, st = steps.spmd(steps.make_train_step(lm, cfg.name))(batch, st)
    params = dict(lm.named_parameters())
    top = max(float(p.abs().max()) for p in ref.parameters())
    param_err = max(float((params[n].full_tensor() - p).abs().max()) / top
                    for n, p in ref.named_parameters())
    moment_err = max(float((st.m[n].full_tensor() - st_ref.m[n]).abs().max())
                     / max(float(st_ref.m[n].abs().max()), 1e-30)
                     for n in specs)
    if rank == 0:
        print(json.dumps({"logits": logit_err, "decode": decode_err,
                          "params": param_err, "moments": moment_err}))
    dist.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "deepseek-moe-16b",
                                  "rwkv6-7b", "jamba-1.5-large-398b",
                                  "internvl2-76b", "qwen2-0.5b"])
def test_gloo_mesh_matches_the_unsharded_port(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               arch], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(4)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got["logits"] <= LOGIT_TOL, got
    assert got["decode"] <= LOGIT_TOL, got
    assert got["params"] <= PARAM_TOL, got
    assert got["moments"] <= MOMENT_TOL, got


def test_pod_record_fields_on_both_meshes(tmp_path):
    """The dry run's production records: per-device temp bytes, the
    collective MB by kind and axis, the collective term in the bound."""
    for mesh in (make_production_mesh(), make_production_mesh(
            multi_pod=True)):
        rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", mesh,
                              out_dir=str(tmp_path), probes=False)
        rl = rec["roofline"]
        assert rec["memory"]["temp_bytes"] > 0 and rec["fits_80gb"]
        assert set(rl["collective_by_axis_mb"]) <= set(mesh.axis_names)
        assert rl["step_time_bound_ms"] == max(rl["terms_ms"].values())
        assert rec["mesh"] == mesh.name and rec["n_devices"] == mesh.size
    assert len(roofline.load_records(str(tmp_path))) == 2
    assert SHAPES["decode_32k"].global_batch == 128
