"""Sharding rules: parameter path -> spec over the production mesh axes
("pod", "data", "model"); the port of ``repro.distributed.sharding``.

Parallelism map, the JAX package's:

* DP: batch over ("pod", "data");
* TP: attention heads, FFN columns and the vocabulary over "model"
  (Megatron);
* EP: MoE experts over "model" (or within each expert's FFN where the
  expert count does not divide the axis);
* SP: long-context decode shards the KV/state sequence over "data";
* ZeRO-3: optimizer moments also sharded over the data axes along the
  first dimension that divides evenly.

Any rule that does not divide the actual shape falls back to
replication for that dimension (``replicated`` lists them, so the dry run
can report it).

These are pure functions of leaf names, shapes and axis sizes.  A tree
is a nested ``dict`` whose leaves have ``.shape`` (tensors, ``meta``
tensors or any stand-in) laid out as the JAX package's parameter and
cache trees (``convert.lm_arrays_from_params``: each group's pattern
positions under ``<group>.l<i>``, stacked on a leading axis over the
repeats in ``blocks`` and Whisper's ``encoder``).  A spec is a tuple
with one entry a dimension: an axis name, a tuple of two or more axis
names or None (``normalize``: a tuple of one name is the name, an empty
one None, as ``jax.sharding.PartitionSpec`` holds them);
``PartitionSpec(*spec)`` is the JAX package's.  A
mesh is anything with ``.shape``, a dict of axis name -> size
(``launch.mesh.MeshSpec``, or a JAX ``Mesh``).

``placements`` turns a spec into DTensor placements over a
``DeviceMesh`` of the same axis names (``launch.mesh.device_mesh``), so
a tensor placed by a spec is a DTensor and DTensor's sharding
propagation partitions the program as XLA's SPMD partitioner does the
JAX package's.
"""

from __future__ import annotations

from itertools import combinations
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

Spec = Tuple

# leaf-name -> spec for the UNSTACKED parameter
_RULES: Dict[str, Tuple] = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "projector": (None, "model"),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # dense mlp
    "w_up": (None, "model"), "w_gate": (None, "model"),
    "w_down": ("model", None),
    # moe (expert-parallel: E over "model")
    "moe.w_up": ("model", None, None), "moe.w_gate": ("model", None, None),
    "moe.w_down": ("model", None, None),
    "router": (None, None),
    # mamba
    "w_in": (None, "model"), "w_conv": (None, "model"),
    "w_bc": ("model", None), "w_dt": ("model", None),
    "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
    "w_out": ("model", None),
    # rwkv
    "w_r": (None, "model"), "w_k": (None, "model"), "w_v": (None, "model"),
    "w_decay": (None, "model"), "w_o": ("model", None),
    "decay_bias": ("model",), "bonus_u": ("model", None),
    "cm_k": (None, "model"), "cm_v": ("model", None), "cm_r": (None, "model"),
    "mu": (None, None), "cm_mu": (None, None),
    # norms
    "w": (None,), "b": (None,),
}

SCANNED_GROUPS = ("blocks", "encoder")  # leaves carry a leading layer dim


def normalize(spec) -> Spec:
    """A spec's entries as ``PartitionSpec`` holds them: a tuple of one
    axis name is the name, an empty tuple None."""
    return tuple(None if ax == () else
                 ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def map_with_path(fn: Callable[[List[str], Any], Any], tree: Any,
                  path: Optional[List[str]] = None) -> Any:
    """``fn(path names, leaf)`` over every leaf of a nested dict."""
    path = path or []
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + [str(k)])
                for k, v in tree.items()}
    return fn(path, tree)


def rule_for(path_names: List[str]) -> Tuple:
    leaf = path_names[-1]
    if len(path_names) >= 2 and path_names[-2] == "moe" \
            and f"moe.{leaf}" in _RULES:
        return _RULES[f"moe.{leaf}"]
    if leaf in _RULES:
        return _RULES[leaf]
    return ()  # replicate unknowns


def _fit(spec: Tuple, shape: Tuple[int, ...],
         axis_sizes: Dict[str, int]) -> Tuple:
    """Pad/trim the rule to the rank and drop non-dividing axes."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    spec = spec[:len(shape)]
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
        else:
            size = axis_sizes.get(ax, 1)
            out.append(ax if dim % size == 0 else None)
    return normalize(out)


def param_spec(names: List[str], shape: Tuple[int, ...], mesh, *,
               stacked: bool = False) -> Spec:
    """The spec of one parameter leaf at ``names`` of ``shape``;
    ``stacked``: its leading dimension is the layers' (a leaf of a
    ``SCANNED_GROUPS`` group), which is never sharded."""
    axis_sizes = dict(mesh.shape)
    rule = rule_for(names)
    core_shape = tuple(shape[1:] if stacked else shape)
    # expert-TP fallback: when the expert count does not divide the
    # model axis (mixtral: 8 experts, 16-way TP), shard WITHIN each
    # expert's FFN instead of replicating everything
    if len(names) >= 2 and names[-2] == "moe" and len(core_shape) == 3 \
            and core_shape[0] % axis_sizes.get("model", 1) != 0:
        if names[-1] in ("w_up", "w_gate"):
            rule = (None, None, "model")
        elif names[-1] == "w_down":
            rule = (None, "model", None)
    if stacked:
        rule = (None,) + tuple(rule)
    return _fit(rule, tuple(shape), axis_sizes)


def param_specs(params_shape: Any, mesh) -> Any:
    """Spec tree matching a parameter (shape) tree."""
    return map_with_path(
        lambda names, leaf: param_spec(
            names, tuple(leaf.shape), mesh,
            stacked=bool(names) and names[0] in SCANNED_GROUPS),
        params_shape)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(ax for ax in ("pod", "data") if ax in mesh.shape)


def batch_spec(mesh) -> Spec:
    """Tokens/labels: batch over all data axes."""
    return normalize((data_axes(mesh),))


def fit_spec(shape: Tuple[int, ...], spec: Spec, mesh) -> Spec:
    """``spec`` with the divisibility fallback applied to every entry:
    of an entry's axes, the sub-tuple (in their order) spanning the most
    devices that still divides its dimension.  The rules apply it to the
    parameters and caches already; the batch's spec names every data
    axis, as the JAX package's does, so prefill_32k's 32 sequences over
    ("pod", "data") = 64 devices shard over "data" and replicate over
    "pod"."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        best: Tuple[str, ...] = ()
        for n in range(len(axes), 0, -1):
            for sub in combinations(axes, n):
                size = axis_size(mesh, sub)
                if dim % size == 0 and size > axis_size(mesh, best):
                    best = sub
        out.append(best)
    return normalize(out)


def cache_specs(cache_shape: Any, mesh, *, seq_shard: bool = False,
                kv_seq_model: bool = False) -> Any:
    """KV caches: batch over data axes, kv-heads over model, unless
    ``seq_shard`` (long context: the batch is too small), which shards
    the SEQUENCE dim over the data axes and heads over model (SP).
    ``kv_seq_model`` (the ``kv_seqshard`` variant): FlashDecoding-style,
    the cache SEQUENCE over the model axis instead of the kv-heads, so
    few-kv-head archs stop replicating the cache 'model'-fold."""
    axis_sizes = dict(mesh.shape)
    daxes = data_axes(mesh)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        stacked = bool(names) and names[0] in SCANNED_GROUPS
        core = shape[1:] if stacked else shape
        if len(core) == 4 and names[-1] in ("k", "v"):  # [B,S,Hk,dh]
            if seq_shard:
                spec = (None, daxes, "model", None)
            elif kv_seq_model:
                spec = (daxes, "model", None, None)
            else:
                spec = (daxes, None,
                        "model" if core[2] % axis_sizes.get("model", 1) == 0
                        else None, None)
        elif names[-1] == "ssm":  # [B,H,dh,N]
            spec = (daxes if not seq_shard else None, "model", None, None)
        elif names[-1] == "wkv":  # [B,H,dhk,dhv]
            spec = (daxes if not seq_shard else None, "model", None, None)
        elif names[-1] == "conv":  # [B,K-1,d_in]
            spec = (daxes if not seq_shard else None, None, "model")
        elif names[-1].startswith("shift"):  # [B,D]
            spec = (daxes if not seq_shard else None, None)
        else:
            spec = (None,) * len(core)
        spec = tuple(spec)
        if stacked:
            spec = (None,) + spec
        # divisibility fallback
        out = []
        for dim, ax in zip(shape, spec):
            if ax is None or ax == ():
                out.append(None)
                continue
            out.append(ax if dim % axis_size(mesh, ax) == 0 else None)
        return normalize(out)

    return map_with_path(one, cache_shape)


def zero_specs(param_specs_tree: Any, params_shape: Any, mesh) -> Any:
    """ZeRO-3: shard optimizer moments over the data axes along the
    first evenly-dividing dimension not already sharded."""
    daxes = data_axes(mesh)
    dsize = axis_size(mesh, daxes)
    shapes = {tuple(p): leaf.shape for p, leaf in items(params_shape)}

    def one(names, spec):
        shape = shapes[tuple(names)]
        spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
        out = list(spec_t)
        for i, (dim, ax) in enumerate(zip(shape, spec_t)):
            if ax is None and dim % dsize == 0:
                out[i] = daxes if len(daxes) > 1 else daxes[0]
                break
        return normalize(out)

    return map_with_path(one, param_specs_tree)


def items(tree: Any) -> List[Tuple[List[str], Any]]:
    """(path names, leaf) of each leaf of a nested dict, in order."""
    out: List[Tuple[List[str], Any]] = []
    map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def axis_size(mesh, ax) -> int:
    """The devices an entry of a spec spans: 1 for None, the axis's size,
    or the product over a tuple of axes."""
    if ax is None:
        return 1
    size = 1
    for a in ((ax,) if isinstance(ax, str) else ax):
        size *= mesh.shape.get(a, 1)
    return size


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` over the ``DeviceMesh`` ``mesh``
    (one entry a mesh dimension, in the mesh's order): ``Shard(d)`` on
    each mesh dimension that entry d of the spec names, ``Replicate()``
    on the others.  A tuple of axes shards its dimension on each of
    them, the first axis outermost, as ``PartitionSpec`` does; the rules'
    tuples follow the mesh's order, which is DTensor's."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def is_placed(t) -> bool:
    """True for a DTensor: a tensor placed over a mesh, of which this
    process holds one device's shard."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def placed_as(t, like):
    """``t`` redistributed to ``like``'s placements where both are placed
    and they differ, else ``t``."""
    if is_placed(t) and is_placed(like) and t.placements != like.placements:
        return t.redistribute(like.device_mesh, like.placements)
    return t


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` under ``spec``: each sharded
    dimension divided by its axes' size, after ``fit_spec``'s fallback."""
    spec = fit_spec(shape, spec, mesh)
    return tuple(dim // axis_size(mesh, ax) for dim, ax in zip(shape, spec))


def replicated(params_shape: Any, mesh) -> List[str]:
    """The parameter leaves whose rule asked for an axis that their shape
    does not divide, and which therefore replicate that dimension:
    ``"<path>: dim <i> (<axis>)"``, the JAX package's divisibility
    fallbacks."""
    axis_sizes = dict(mesh.shape)
    got = {tuple(p): s for p, s in items(param_specs(params_shape, mesh))}
    out = []
    for names, leaf in items(params_shape):
        rule = rule_for(names)
        if names and names[0] in SCANNED_GROUPS:
            rule = (None,) + tuple(rule)
        rule = tuple(rule) + (None,) * (len(leaf.shape) - len(rule))
        spec = got[tuple(names)]
        for i, (want, have) in enumerate(zip(rule, spec)):
            if want is not None and have is None and want not in spec \
                    and axis_sizes.get(want, 1) > 1:
                out.append(f"{'.'.join(names)}: dim {i} ({want})")
    return out


class NamedSpec(NamedTuple):
    """A spec paired with its mesh (``jax.sharding.NamedSharding``'s
    counterpart; it places nothing)."""
    mesh: Any
    spec: Spec


def named(mesh, tree: Any) -> Any:
    return map_with_path(lambda _, s: NamedSpec(mesh, s), tree)


__all__ = ["NamedSpec", "SCANNED_GROUPS", "axis_size", "batch_spec",
           "cache_specs", "data_axes", "fit_spec", "is_placed", "items",
           "local_shape", "map_with_path", "named", "normalize", "param_spec",
           "param_specs", "placed_as", "placements", "replicated", "rule_for",
           "zero_specs"]
