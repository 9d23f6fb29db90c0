"""Carry state across from plain arrays: a persistence domain, and a
model's parameters.

The state of this system is its PM image, so carrying a table over
from another process or package is what carrying weights over is for a
model: ``pmem_from_arrays`` builds a port ``PMem`` from plain numpy
arrays, and ``PCLHT(pmem, name=...)`` then attaches to the table it
holds through the index's ordinary restart path.  The tests build the
arrays from the JAX package's ``PMem`` regions and hold both packages
to the same table.

``lm_params_from_arrays`` turns the JAX package's ``LM`` parameter tree
(as numpy arrays: each group's pattern positions under ``<group>.l<i>``,
stacked on axis 0 over the group's repeats; Whisper's ``encoder``
stacked on axis 0 always; any family of the registry) into the port
``LM``'s state dict, so both packages run the same
weights; ``lm_arrays_from_params`` is its inverse (the tree the
checkpoint store saves and restores), and ``adamw_state_from_arrays``
carries an optimizer state (step, m, v, master) across the same way.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.pmem import WORDS_PER_LINE, OpCounters, PMem, Region
from .models.model import group_plan, layer_slots
from .optim.adamw import AdamWState


def pmem_from_arrays(regions: Iterable[Mapping], next_rid: int, *,
                     counters: Optional[Mapping[str, int]] = None,
                     seed: int = 0) -> PMem:
    """A ``PMem`` holding the given regions.

    Each region is a mapping with ``rid``, ``name``, ``cache`` and
    ``pm`` (int64 word arrays of one length) and ``stores`` (the
    region's store count, which the foreign-writer check reads).
    ``next_rid`` is the id the next allocation takes; ``counters``
    holds the ``OpCounters`` fields; ``seed`` seeds the eviction RNG.
    A line whose cache and pm words differ is dirty (written, not yet
    flushed); every other line is clean, as after any completed op."""
    pmem = PMem(seed=seed)
    for spec in regions:
        cache = np.array(spec["cache"], dtype=np.int64)
        pm = np.array(spec["pm"], dtype=np.int64)
        if cache.ndim != 1 or cache.shape != pm.shape:
            raise ValueError(f"region {spec['name']!r}: cache and pm must "
                             f"be 1-D arrays of one length")
        rid = int(spec["rid"])
        if rid in pmem.regions or rid >= next_rid:
            raise ValueError(f"region id {rid} is repeated or not below "
                             f"next_rid={next_rid}")
        region = Region(str(spec["name"]), rid, cache.shape[0])
        region.cache, region.pm = cache, pm
        region.stores = int(spec["stores"])
        differs = np.nonzero(cache != pm)[0] // WORDS_PER_LINE
        region.dirty = set(np.unique(differs).tolist())
        pmem.regions[rid] = region
        pmem.alloc_log.append(rid)
    pmem._next_rid = int(next_rid)
    if counters is not None:
        pmem.counters = OpCounters(**{k: int(v) for k, v in counters.items()})
    return pmem


def _tensor(a, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:                           # cannot take from numpy directly
        t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _leaves(tree: Mapping, prefix: str):
    """(port name, array) of each leaf of one layer's part; a nested
    dict (a MoE layer's ``shared`` experts) becomes the part
    ``<part>_<name>``, as the port's ``Block`` holds it."""
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            yield from _leaves(leaf, f"{prefix}_{name}")
        else:
            yield f"{prefix}.{name}", (
                leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf))


def lm_params_from_arrays(params: Mapping, cfg: ArchConfig, *,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """The port ``LM``'s state dict for ``cfg`` from the JAX package's
    parameter tree.

    ``params`` is the JAX ``LM.init_params`` tree with numpy leaves:
    ``embed``, ``final_norm.w`` (and ``.b`` for LayerNorm), optionally
    ``lm_head``, and for each group of ``group_plan(cfg)``
    ``<group>.l<i>.<part>.<name>`` for each of its pattern's positions,
    stacked on axis 0 over the group's repeats (unstacked when the group
    runs once, as the JAX package builds it).  ``layer_slots(cfg)`` says
    which (group, position, repeat) each port layer is.  The parts are
    ``ln1``, a mixer (``attn``, ``mamba`` or ``rwkv``; Whisper's decoder
    layers also ``ln3`` and ``cross``), ``ln2`` and an FFN (``ffn`` or
    ``moe``, whose shared experts are nested under ``moe.shared`` and
    become ``moe_shared``; RWKV6 has none).  Whisper's ``encoder.<part>.
    <name>`` is stacked on axis 0 over its layers even when there is one
    (the JAX package builds it with ``jax.vmap``) and becomes
    ``encoder.<e>.<part>.<name>``; ``enc_norm`` and InternVL's
    ``projector`` carry over by name.  Each leaf
    keeps its dtype unless ``dtype`` is given.  Load the result with
    ``LM.load_state_dict(sd, assign=True)`` so the dtypes carry over."""
    out = {"embed": _tensor(params["embed"], dtype)}
    for name, leaf in params["final_norm"].items():  # w, and LayerNorm's b
        out[f"final_norm.{name}"] = _tensor(leaf, dtype)
    if "lm_head" in params:
        out["lm_head"] = _tensor(params["lm_head"], dtype)
    if "projector" in params:
        out["projector"] = _tensor(params["projector"], dtype)
    if "encoder" in params:
        for name, leaf in params["enc_norm"].items():
            out[f"enc_norm.{name}"] = _tensor(leaf, dtype)
        for e in range(cfg.encdec.n_enc_layers):
            for part, leaves in params["encoder"].items():
                for name, leaf in _leaves(leaves, part):
                    out[f"encoder.{e}.{name}"] = _tensor(leaf[e], dtype)
    for layer, (group, pos, r) in enumerate(layer_slots(cfg)):
        for part, leaves in params[group][pos].items():
            for name, leaf in _leaves(leaves, part):
                out[f"layers.{layer}.{name}"] = _tensor(
                    leaf if r is None else leaf[r], dtype)
    return out


def lm_arrays_from_params(params: Mapping[str, torch.Tensor],
                          cfg: ArchConfig) -> Dict:
    """The JAX package's parameter tree for ``cfg`` from the port
    ``LM``'s state dict (or any dict keyed by its names): the inverse of
    ``lm_params_from_arrays``.  Each group's pattern positions sit under
    ``<group>.l<i>``, stacked on axis 0 over the group's repeats
    (``torch.stack``, a copy) and unstacked when it runs once; a part
    ``moe_shared`` becomes ``moe.shared``; Whisper's ``encoder.<e>`` are
    stacked on axis 0 (always).  Leaves keep their dtype and device."""
    tree: Dict = {"embed": params["embed"]}
    for top in ("final_norm", "enc_norm"):
        sub = {name.split(".", 1)[1]: t for name, t in params.items()
               if name.startswith(top + ".")}
        if sub:
            tree[top] = sub
    for top in ("lm_head", "projector"):
        if top in params:
            tree[top] = params[top]

    def layer_tree(prefix: str) -> Dict:
        one: Dict = {}
        for name, t in params.items():
            if not name.startswith(prefix):
                continue
            part, leaf = name[len(prefix):].split(".", 1)
            if "_" in part:  # moe_shared: the nested moe.shared
                part, sub = part.split("_", 1)
                one.setdefault(part, {}).setdefault(sub, {})[leaf] = t
            else:
                one.setdefault(part, {})[leaf] = t
        return one

    def stack(layers: List):
        if isinstance(layers[0], Mapping):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return torch.stack(layers)

    if cfg.encdec is not None:
        tree["encoder"] = stack([layer_tree(f"encoder.{e}.")
                                 for e in range(cfg.encdec.n_enc_layers)])
    per_slot: Dict = {}  # (group, position) -> one layer dict a repeat
    for layer, (group, pos, _) in enumerate(layer_slots(cfg)):
        per_slot.setdefault((group, pos), []).append(
            layer_tree(f"layers.{layer}."))
    repeats = {name: repeat for name, _, repeat in group_plan(cfg)}

    for (group, pos), layers in per_slot.items():
        tree.setdefault(group, {})[pos] = (
            stack(layers) if repeats[group] > 1 else layers[0])
    return tree


def adamw_state_from_arrays(state, cfg: ArchConfig, *,
                            device=None) -> AdamWState:
    """The port's ``AdamWState`` from the JAX package's (``step``, and
    ``m``, ``v`` and ``master`` as parameter trees with numpy leaves),
    keyed by the port ``LM``'s parameter names, fp32 on ``device``."""
    def leaves(tree):
        out = lm_params_from_arrays(tree, cfg, dtype=torch.float32)
        return {k: t if device is None else t.to(device)
                for k, t in out.items()}

    return AdamWState(step=int(np.asarray(state.step)), m=leaves(state.m),
                      v=leaves(state.v), master=leaves(state.master))


__all__ = ["adamw_state_from_arrays", "lm_arrays_from_params",
           "lm_params_from_arrays", "pmem_from_arrays"]
