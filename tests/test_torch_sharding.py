"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the JAX package's (``repro.distributed.sharding``), on the CPU.

For all ten configurations at full width, nothing allocated: the JAX
side's parameter and cache trees come from ``jax.eval_shape``
(``LM.params_spec()``, ``LM.cache_spec``), the port's from its model on
``meta`` (``launch.steps.params_tree``, ``LM.init_caches``).  The JAX
rules take a stand-in mesh (an object with ``.shape``), so no devices
are needed.  Meshes: (1, 1), the JAX package's (16, 16) and (2, 16, 16),
and the port's H100 meshes (32, 8) and (2, 32, 8).  Tolerance: none;
every spec is equal, as a tuple, leaf for leaf.
"""

import functools
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jshard
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import all_archs, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import (MeshSpec, make_production_mesh,
                                     make_smoke_mesh)


class StandIn:
    """What the JAX rules read of a mesh: its axis sizes."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)


MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "32x8": (("data", "model"), (32, 8)),
    "2x32x8": (("pod", "data", "model"), (2, 32, 8)),
}
ARCHS = all_archs()


def as_tuples(tree):
    """A JAX spec tree as nested dicts of tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def jax_trees(arch):
    jm = jax_build_model(jax_get_arch(arch))
    return jm, jm.params_spec()


@functools.lru_cache(maxsize=None)
def port_trees(arch):
    model = steps.meta_model(get_arch(arch))
    return model, steps.params_tree(model)


def test_registries_agree():
    assert sorted(ARCHS) == sorted(jax_all_archs()) and len(ARCHS) == 10


def test_meshes_are_the_deployments():
    """The one card; 256 and 512 devices as HGX nodes of 8 cards."""
    assert make_smoke_mesh().shape == {"data": 1, "model": 1}
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 32, "model": 8} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.size == 512 and multi.name == "2x32x8"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero_specs_equal_jax(arch, mesh):
    """``param_specs`` and ``zero_specs`` leaf for leaf, and
    ``data_axes``, as the JAX functions give them."""
    names, sizes = MESHES[mesh]
    jm, jparams = jax_trees(arch)
    _, params = port_trees(arch)
    jmesh, tmesh = StandIn(names, sizes), MeshSpec(names, sizes)
    # the same tree, leaf for leaf and shape for shape
    assert as_tuples(jax.tree.map(lambda s: P(*s.shape), jparams)) == \
        sharding.map_with_path(lambda _, t: tuple(t.shape), params)
    jspecs = jshard.param_specs(jparams, jmesh)
    tspecs = sharding.param_specs(params, tmesh)
    assert as_tuples(jspecs) == tspecs
    assert as_tuples(jshard.zero_specs(jspecs, jparams, jmesh)) == \
        sharding.zero_specs(tspecs, params, tmesh)
    assert jshard.data_axes(jmesh) == sharding.data_axes(tmesh)
    assert tuple(jshard.batch_spec(jmesh)) == sharding.batch_spec(tmesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, mesh):
    """``cache_specs`` at decode_32k's caches (B = 128, 32,768 slots),
    plain, with ``kv_seq_model``, and with ``seq_shard`` over
    long_500k's one sequence."""
    names, sizes = MESHES[mesh]
    jm, _ = jax_trees(arch)
    model, _ = port_trees(arch)
    jmesh, tmesh = StandIn(names, sizes), MeshSpec(names, sizes)
    for B, S, kw in ((128, 32768, {}), (128, 32768, {"kv_seq_model": True}),
                     (1, 524288, {"seq_shard": True})):
        jc = jm.cache_spec(B, S)
        tc = model.init_caches(B, S)
        assert as_tuples(jax.tree.map(lambda s: P(*s.shape), jc)) == \
            sharding.map_with_path(lambda _, t: tuple(t.shape), tc)
        assert as_tuples(jshard.cache_specs(jc, jmesh, **kw)) == \
            sharding.cache_specs(tc, tmesh, **kw), kw


def test_local_shape_divides_the_sharded_dims():
    mesh = make_production_mesh(multi_pod=True)
    assert sharding.local_shape((128, 32768, 2, 64),
                                (("pod", "data"), None, None, None),
                                mesh) == (2, 32768, 2, 64)
    assert sharding.local_shape((896, 896), (None, "model"), mesh) == \
        (896, 112)
    assert sharding.local_shape((896, 151936), (None, None), mesh) == \
        (896, 151936)


def test_replicated_lists_the_fallbacks():
    """Qwen2-0.5B's 2 kv heads do not divide a model axis of 8: wk and
    wv (896 x 128) keep their columns, 128 divides 8; its 14 heads make
    wq 896 x 896, which divides; the embedding's 151,936 rows divide 8.
    Jamba's 16 experts divide 8.  Whisper's 51,865-word vocabulary does
    not: the embedding falls back to replication over "model"."""
    mesh = make_production_mesh()
    _, qwen = port_trees("qwen2-0.5b")
    assert sharding.replicated(qwen, mesh) == []
    _, whisper = port_trees("whisper-tiny")
    got = sharding.replicated(whisper, mesh)
    assert "embed: dim 0 (model)" in got
    spec = sharding.param_specs(whisper, mesh)["embed"]
    assert spec == (None, None)


def test_named_pairs_each_spec_with_its_mesh():
    mesh = make_smoke_mesh()
    tree = {"a": ("data", None), "b": {"c": (None,)}}
    named = sharding.named(mesh, tree)
    assert named["a"] == sharding.NamedSpec(mesh, ("data", None))
    assert named["b"]["c"].spec == (None,)
    assert np.prod(list(mesh.shape.values())) == 1


@pytest.mark.parametrize("variants", [(), ("dp_only",), ("kv_seqshard",)])
@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", "train_4k"),
                                        ("whisper-tiny", "decode_32k"),
                                        ("jamba-1.5-large-398b", "long_500k"),
                                        ("deepseek-moe-16b", "prefill_32k")])
def test_cell_shardings_equal_jax(arch, shape, variants):
    """``launch.steps.cell_shardings``, every argument's specs (the AdamW
    state's under ``opt``), as JAX's, on the port's 2 x 32 x 8 mesh."""
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.launch import steps as jsteps
    from repro_torch.configs.base import SHAPES
    names, sizes = MESHES["2x32x8"]
    jm, _ = jax_trees(arch)
    model, _ = port_trees(arch)
    v = frozenset(variants)
    jspecs = jsteps.input_specs(jm.cfg, JAX_SHAPES[shape], jm)
    want = jsteps.cell_shardings(jm.cfg, JAX_SHAPES[shape],
                                 StandIn(names, sizes), jm, jspecs, v)
    got = steps.cell_shardings(model.cfg, SHAPES[shape],
                               MeshSpec(names, sizes), model,
                               steps.input_specs(model.cfg, SHAPES[shape],
                                                 model), v)
    if "opt" in want:
        opt = want.pop("opt")
        want["opt"] = {"step": tuple(opt.step),
                       **{k: getattr(opt, k) for k in ("m", "v", "master")}}
    assert set(got) == set(want)
    for key in want:
        assert got[key] == as_tuples(want[key]), key
