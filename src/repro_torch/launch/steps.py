"""Step functions and the dry run's cells: the port of
``repro.launch.steps``.

The step functions (``make_train_step``, ``make_prefill_step``,
``make_decode_step``): a train step runs the loss forward and
``loss.backward()`` through the port's kernels (attention forward and
backward on the flash-attention kernels, RWKV6's and Mamba's scans
forward and backward on the WKV6 and SSD kernels), then AdamW at the
architecture's schedule (WSD for MiniCPM, cosine otherwise) at step
``state.step + 1``; the model's parameters are updated in place, where
the JAX step returns new ones.

The dry run's half (the JAX package lowers each (arch x shape) cell
with ``jax.jit(...).lower`` on ``ShapeDtypeStruct``s): ``batch_specs``
and ``input_specs`` give ``meta`` tensors of the JAX package's shapes and
dtypes, ``cell_shardings`` the specs of every argument over a mesh
(``distributed.sharding``), ``lower_cell`` the model built on ``meta``
(no weight drawn) with its step and ``meta`` arguments, and
``group_probes`` one application of each repeated group's body, in the
cell's mode.  ``analysis.roofline.count_costs`` runs them.  On a
production mesh both run inside ``launch.mesh.device_mesh(mesh)`` as
one device's share: the model's parameters (``lm_specs``, one layer's
spec of the rules), the inputs and AdamW's state (``zero_specs``) are
DTensors over its ``DeviceMesh`` (``place``), and the step runs under
``spmd``, so DTensor partitions it as XLA's SPMD partitioner does the
JAX package's.

``apply_variants`` takes the JAX package's variants: ``moe_sorted`` and
``cf1`` change the MoE config, ``kv_int8`` (in ``lower_cell``) sets
``LM.cache_dtype`` to int8, ``dp_only`` and ``kv_seqshard`` change the
specs.  ``scores_bf16`` sets the JAX package's ``SCORE_DTYPE``, which
halves its materialized [T, T] scores; the port's attention kernels keep
scores in fp32 registers and materialize no [T, T] matrix, so the
variant is recorded in the cell and changes neither the count nor the
result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..convert import lm_arrays_from_params
from ..distributed import sharding as shard_rules
from ..models.model import LM, group_plan
from ..optim import adamw, schedules
from ..optim.adamw import AdamWState
from . import mesh as mesh_mod


def make_train_step(model: LM, arch_name: str, *,
                    total_steps: int = 10_000) -> Callable:
    """``train_step(batch, opt_state) -> (loss, new opt_state)``:
    ``batch`` holds ``tokens`` and ``labels`` [B, T] (and Whisper's
    ``frames`` or InternVL's ``patches``); the loss is a 0-d fp32 tensor
    on the model's device, detached.  Turns the model's
    parameters trainable."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(batch: Dict[str, torch.Tensor], opt_state: AdamWState
                   ) -> Tuple[torch.Tensor, AdamWState]:
        for p in params.values():
            p.grad = None
        loss = model.loss(batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        lr = schedules.for_arch(arch_name, opt_state.step + 1,
                                total=total_steps)
        _, new_state = adamw.update(grads, opt_state, params, lr=lr)
        del grads
        for p in params.values():  # free the gradients before the next step
            p.grad = None
        return loss.detach(), new_state

    return train_step


def make_prefill_step(model: LM, seq_len: int) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch, seq_len)

    return prefill_step


def make_decode_step(model: LM, *, with_enc: bool = False) -> Callable:
    """``decode_step(token, caches, pos)``, or with ``with_enc``
    ``decode_step(token, caches, pos, enc)`` for the encoder-decoder
    family (Whisper), whose cross attention reads the encoder's output
    ``enc`` (``model._encode(frames)``)."""
    if with_enc:
        def decode_step(token, caches, pos, enc):
            return model.decode_step(token, caches, pos, enc=enc)
    else:
        def decode_step(token, caches, pos):
            return model.decode_step(token, caches, pos)
    return decode_step


# ----------------------------------------------------------------------
# input specs (meta tensors: never allocated)
# ----------------------------------------------------------------------
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tok(shape) -> torch.Tensor:
    return _meta(shape, torch.int32)


def batch_specs(cfg: ArchConfig, B: int, T: int) -> Dict[str, torch.Tensor]:
    batch: Dict[str, torch.Tensor] = {}
    t_text = T
    if cfg.vision is not None:
        t_text = T - cfg.vision.n_patches
        batch["patches"] = _meta((B, cfg.vision.n_patches, cfg.vision.d_vit),
                                 torch.bfloat16)
    if cfg.encdec is not None:
        batch["frames"] = _meta((B, cfg.encdec.n_audio_frames, cfg.d_model),
                                torch.bfloat16)
    batch["tokens"] = _tok((B, t_text))
    batch["labels"] = _tok((B, t_text))
    return batch


def meta_model(cfg: ArchConfig, remat: str = "full") -> LM:
    """``LM(cfg, remat=remat)`` on ``meta``: the parameters' shapes and
    dtypes, no weights drawn."""
    return LM(cfg, device="meta", remat=remat)


def input_specs(cfg: ArchConfig, shape: ShapeCfg,
                model: Optional[LM] = None) -> Dict[str, Any]:
    """Stand-ins for every model input of this cell: ``meta`` tensors of
    the JAX package's shapes and dtypes (int32 tokens and positions, bf16
    frames and patches; the caches of ``model.init_caches(B, T)``)."""
    model = model or meta_model(cfg)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, B, T)}
    # decode: one new token against a seq_len cache
    spec = {"token": _tok((B,)), "caches": model.init_caches(B, T),
            "pos": _tok((B,))}
    if cfg.encdec is not None:
        spec["enc"] = _meta((B, cfg.encdec.n_audio_frames, cfg.d_model),
                            torch.bfloat16)
    return spec


def params_tree(model: LM) -> Dict[str, Any]:
    """The model's parameters in the JAX package's tree
    (``convert.lm_arrays_from_params``), the layout the sharding rules
    read."""
    return lm_arrays_from_params(dict(model.named_parameters()), model.cfg)


def opt_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """AdamW's state as the JAX package's ``init_spec`` lays it out: an
    int32 step and fp32 m, v and master trees like the parameters."""
    f32 = lambda _, p: _meta(tuple(p.shape), torch.float32)  # noqa: E731
    return {"step": _meta((), torch.int32),
            "m": shard_rules.map_with_path(f32, params),
            "v": shard_rules.map_with_path(f32, params),
            "master": shard_rules.map_with_path(f32, params)}


# ----------------------------------------------------------------------
# shardings per cell
# ----------------------------------------------------------------------
def _replicate(_, t) -> Tuple:
    return (None,) * len(t.shape)


def cell_shardings(cfg: ArchConfig, shape: ShapeCfg, mesh, model: LM,
                   specs: Dict[str, Any],
                   variants: frozenset = frozenset()) -> Dict[str, Any]:
    """Spec trees for params / opt state / inputs, as the JAX package's
    ``cell_shardings`` gives them (``opt`` as a dict of ``step``, ``m``,
    ``v``, ``master``)."""
    params = params_tree(model)
    if "dp_only" in variants:
        # small models: TP wastes collectives and replicates attention
        # scores when heads don't divide the axis: pure DP over the WHOLE
        # mesh with fully-sharded (ZeRO-3) optimizer state
        all_axes = tuple(mesh.shape.keys())

        def over_all(_, t) -> Tuple:
            if t.shape and t.shape[0] % mesh.size == 0:
                return shard_rules.normalize(
                    (all_axes,) + (None,) * (len(t.shape) - 1))
            return (None,) * len(t.shape)

        out: Dict[str, Any] = {
            "params": shard_rules.map_with_path(_replicate, params)}
        if shape.kind in ("train", "prefill"):
            out["batch"] = shard_rules.map_with_path(
                lambda _, t: shard_rules.normalize(
                    (all_axes,) + (None,) * (len(t.shape) - 1)),
                specs["batch"])
        else:
            out["token"] = shard_rules.normalize((all_axes,))
            out["pos"] = shard_rules.normalize((all_axes,))
            out["caches"] = shard_rules.map_with_path(over_all,
                                                      specs["caches"])
        if shape.kind == "train":
            opt = opt_tree(params)
            out["opt"] = {"step": (),
                          **{k: shard_rules.map_with_path(over_all, opt[k])
                             for k in ("m", "v", "master")}}
        return out
    pspecs = shard_rules.param_specs(params, mesh)
    out = {"params": pspecs}
    daxes = shard_rules.data_axes(mesh)
    if shape.kind in ("train", "prefill"):
        out["batch"] = shard_rules.map_with_path(
            lambda _, t: shard_rules.normalize(
                (daxes,) + (None,) * (len(t.shape) - 1)), specs["batch"])
    else:
        seq_shard = shape.name.startswith("long")  # SP for 500k decode
        out["token"] = shard_rules.normalize(
            (daxes if not seq_shard else None,))
        out["pos"] = out["token"]
        out["caches"] = shard_rules.cache_specs(
            specs["caches"], mesh, seq_shard=seq_shard,
            kv_seq_model="kv_seqshard" in variants)
        if "enc" in specs:
            out["enc"] = shard_rules.normalize((daxes, None, None)) \
                if not seq_shard else (None, None, None)
    if shape.kind == "train":
        out["opt"] = {"step": (),
                      **{k: shard_rules.zero_specs(pspecs, params, mesh)
                         for k in ("m", "v", "master")}}
    return out


# ----------------------------------------------------------------------
# placing a cell's tensors over a DeviceMesh (launch.mesh.device_mesh)
# ----------------------------------------------------------------------
Make = Callable[[str, torch.Tensor, Tuple[int, ...]], torch.Tensor]


def _empty(_, t, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=t.dtype, device=META)


def place(t: torch.Tensor, spec, dmesh, make: Make = _empty,
          name: str = "") -> torch.Tensor:
    """A DTensor of ``t``'s shape and dtype placed by ``spec`` (after
    ``sharding.fit_spec``'s fallback) over the ``DeviceMesh`` ``dmesh``,
    whose rank-0 shard is ``make(name, t, local shape)``: an empty
    ``meta`` tensor by default, or the shard's values drawn on the card
    (``chip_smoke.py``), so no whole tensor is made."""
    from torch.distributed.tensor import DTensor, Shard

    spec = shard_rules.fit_spec(tuple(t.shape), spec, dmesh_spec(dmesh))
    pl = shard_rules.placements(spec, dmesh)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= dmesh.size(i)
    return DTensor.from_local(make(name, t, tuple(local)), dmesh, pl,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device=META)
                              .stride())


def dmesh_spec(dmesh):
    """The ``MeshSpec`` of a ``DeviceMesh``."""
    return mesh_mod.MeshSpec(tuple(dmesh.mesh_dim_names),
                             tuple(dmesh.mesh.shape))


def place_tree(tree: Any, specs: Any, dmesh, make: Make = _empty,
               name: str = "") -> Any:
    """``place`` over every leaf of a nested dict and its spec tree, each
    named by its path from ``name`` ("caches.blocks.l0.k")."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], dmesh, make, f"{name}.{k}")
                for k, v in tree.items()}
    return place(tree, specs, dmesh, make, name)


def lm_specs(model: LM, mesh) -> Dict[str, Tuple]:
    """Each of ``model``'s parameters' spec, by its name: the rules'
    spec of its leaf in the JAX package's tree, without the leading
    layer dimension of a ``SCANNED_GROUPS`` leaf (one layer's
    parameters)."""
    return {name: shard_rules.param_spec(name.split("."), tuple(p.shape),
                                         mesh)
            for name, p in model.named_parameters()}


def place_model(model: LM, specs: Dict[str, Tuple], dmesh,
                make: Make = _empty) -> None:
    """Replace each of ``model``'s parameters by a DTensor placed by its
    spec (``lm_specs``), its shard made by ``make``; the parameters stay
    frozen."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        new = torch.nn.Parameter(place(p, specs[name], dmesh, make, name),
                                 requires_grad=False)
        if isinstance(module, torch.nn.ParameterDict):
            module[leaf] = new
        else:
            setattr(module, leaf, new)


def place_opt_state(model: LM, specs: Dict[str, Tuple], mesh, dmesh,
                    make: Make = _empty) -> AdamWState:
    """AdamW's state for ``model``'s parameters placed by ``specs``: fp32
    m, v and master of each parameter's shape placed by
    ``sharding.zero_specs`` (the ZeRO-3 shard over the data axes)."""
    params = {n: p for n, p in model.named_parameters()}
    zspecs = shard_rules.zero_specs(specs, params, mesh)

    def tree(kind):
        return {n: place(_meta(tuple(p.shape), torch.float32), zspecs[n],
                         dmesh, make, f"opt.{kind}.{n}")
                for n, p in params.items()}

    return AdamWState(step=0, m=tree("m"), v=tree("v"),
                      master=tree("master"))


def spmd(fn: Callable) -> Callable:
    """``fn`` run with plain tensors taken as replicated wherever they
    meet DTensors (positions, masks and the like made inside the step)."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return run


def named_tree(mesh, tree):
    """Each spec of ``tree`` paired with ``mesh``
    (``sharding.NamedSpec``)."""
    return shard_rules.named(mesh, tree)


# ----------------------------------------------------------------------
# lower one cell
# ----------------------------------------------------------------------
def apply_variants(cfg: ArchConfig, variants: frozenset) -> ArchConfig:
    """The config under ``variants``: ``moe_sorted`` and ``cf1`` replace
    the MoE settings as the JAX package does; the others change the
    model (``kv_int8``), the specs (``dp_only``, ``kv_seqshard``) or
    nothing the port computes (``scores_bf16``: the module docstring)."""
    if "moe_sorted" in variants and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="sorted"))
    if "cf1" in variants and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    return cfg


@dataclasses.dataclass
class Lowered:
    """A cell's step and its ``meta`` arguments (the counterpart of a
    ``jax.stages.Lowered``): ``fn(*args)`` runs it; ``arg_specs`` and
    ``shardings`` pair each argument's JAX-layout shapes with its specs
    (for the per-device argument bytes)."""
    fn: Callable
    args: Tuple
    arg_specs: Dict[str, Any]
    shardings: Dict[str, Any]


def _cell_model(cfg: ArchConfig, variants: frozenset, remat: str = "full"
                ) -> Tuple[ArchConfig, LM]:
    cfg = apply_variants(cfg, variants)
    model = meta_model(cfg, remat)
    if "kv_int8" in variants:
        model.cache_dtype = torch.int8
    return cfg, model


def lower_cell(cfg: ArchConfig, shape: ShapeCfg, mesh, *,
               variants: frozenset = frozenset(), make: Make = _empty,
               remat: str = "full") -> Tuple[Lowered, LM]:
    """(the cell's step on ``meta``, the model): a train step (forward,
    backward under ``remat``, the JAX package's default ``"full"``, and
    AdamW) over the batch, a prefill, or one decode token against
    ``seq_len`` slots of cache.  On a production mesh, inside
    ``launch.mesh.device_mesh(mesh)``, one device's share: the model,
    the arguments and AdamW's state placed as DTensors (``place``, rank
    0's shards made by ``make``, named "embed", "layers.0.attn.wq", ...,
    "batch.tokens", "token", "caches.blocks.l0.k", "pos",
    "opt.m.embed", ...), the step run under ``spmd``."""
    cfg, model = _cell_model(cfg, variants, remat)
    specs = input_specs(cfg, shape, model)
    shardings = cell_shardings(cfg, shape, mesh, model, specs, variants)
    params = params_tree(model)
    run, given, pspecs = _placed(model, mesh, shardings, specs, variants,
                                 make)
    if shape.kind == "train":
        step = make_train_step(model, cfg.name)
        opt_state = (adamw.init(dict(model.named_parameters()))
                     if mesh.size == 1 else
                     place_opt_state(model, pspecs, mesh,
                                     mesh_mod.current(mesh), make))
        arg_specs = {"params": params, "opt": opt_tree(params),
                     "batch": specs["batch"]}
        return Lowered(run(step), (given["batch"], opt_state), arg_specs,
                       shardings), model
    if shape.kind == "prefill":
        step = make_prefill_step(model, shape.seq_len)
        return Lowered(run(step), (given["batch"],),
                       {"params": params, "batch": specs["batch"]},
                       shardings), model
    with_enc = cfg.encdec is not None
    step = make_decode_step(model, with_enc=with_enc)
    names = ("token", "caches", "pos") + (("enc",) if with_enc else ())
    arg_specs = {"params": params, **{k: specs[k] for k in names}}
    return Lowered(run(step), tuple(given[k] for k in names), arg_specs,
                   shardings), model


def _placed(model: LM, mesh, shardings: Dict[str, Any],
            specs: Dict[str, Any], variants: frozenset, make: Make = _empty
            ) -> Tuple[Callable, Dict[str, Any], Dict[str, Tuple]]:
    """On the one-card mesh (identity, ``specs``, None); on a production
    mesh (``spmd``, ``specs`` placed by ``shardings``, the parameters'
    specs), with ``model``'s parameters placed by ``lm_specs``
    (replicated under ``dp_only``): one device's share of the cell, over
    ``launch.mesh.current(mesh)``."""
    if mesh.size == 1:
        return (lambda fn: fn), specs, None
    dmesh = mesh_mod.current(mesh)
    pspecs = lm_specs(model, mesh)
    if "dp_only" in variants:
        pspecs = {n: (None,) * len(s) for n, s in pspecs.items()}
    place_model(model, pspecs, dmesh, make)
    given = {k: place_tree(v, shardings[k], dmesh, make, k)
             for k, v in specs.items()}
    return spmd, given, pspecs


# ----------------------------------------------------------------------
# per-group probe programs (one application of a repeated body)
# ----------------------------------------------------------------------
def group_probes(cfg: ArchConfig, shape: ShapeCfg, mesh,
                 variants: frozenset = frozenset()
                 ) -> List[Tuple[str, int, Lowered]]:
    """For each group with repeat > 1, one application of its body (the
    group's first pattern's layers) in the cell's mode: train, forward
    and backward (the gradients of the layers' parameters and of x);
    prefill, forward; decode, one token against the group's caches.
    The body runs without remat regions, as the JAX package's probes do.
    Returns [(group name, repeat, Lowered)]."""
    cfg, model = _cell_model(cfg, variants)
    B, T = shape.global_batch, shape.seq_len
    layer0, out = 0, []
    specs = input_specs(cfg, shape, model)
    enc = (_meta((B, cfg.encdec.n_audio_frames, cfg.d_model), torch.bfloat16)
           if cfg.encdec is not None else None)
    shardings = cell_shardings(cfg, shape, mesh, model, specs, variants)
    run, specs, _ = _placed(model, mesh, shardings, specs, variants)
    if mesh.size > 1:  # x and enc over the batch's axes, as the step's
        daxes = (tuple(mesh.shape) if "dp_only" in variants
                 else shard_rules.data_axes(mesh))
        bspec = (daxes,)
        dmesh = mesh_mod.current(mesh)
        enc = (place(enc, bspec + (None, None), dmesh)
               if enc is not None else None)
    for gname, pattern, repeat in group_plan(cfg):
        blocks = list(model.layers[layer0:layer0 + len(pattern)])
        first = layer0
        layer0 += len(pattern) * repeat
        if repeat <= 1:
            continue
        if shape.kind == "decode":
            x = _meta((B, 1, cfg.d_model), torch.bfloat16)
            if mesh.size > 1:
                x = place(x, bspec + (None, None), dmesh)
            caches = [model._layer_cache(specs["caches"], first + i)
                      for i in range(len(pattern))]

            def probe(x, caches, pos, enc, blocks=blocks):
                pos = pos.to(torch.int64)
                for blk, cache in zip(blocks, caches):
                    x, _ = model._decode_layer(blk, x, cache, pos, enc, None)
                return x

            args = (x, caches, specs["pos"], specs.get("enc"))
        else:
            x = _meta((B, T, cfg.d_model), torch.bfloat16)
            if mesh.size > 1:
                x = place(x, bspec + (None, None), dmesh)

            def body(x, blocks=blocks):
                for blk in blocks:
                    x, _ = model._forward_layer(blk, x, enc)
                return x

            if shape.kind == "train":
                def probe(x, blocks=blocks, body=body):
                    for blk in blocks:
                        blk.requires_grad_(True)
                    x = x.detach().requires_grad_(True)
                    body(x).float().sum().backward()
                    return x.grad
            else:
                def probe(x, body=body):
                    with torch.no_grad():
                        return body(x)
            args = (x,)
        out.append((gname, repeat, Lowered(run(probe), args, {}, {})))
    return out


__all__ = ["Lowered", "apply_variants", "batch_specs", "cell_shardings",
           "group_probes", "input_specs", "lm_specs", "lower_cell",
           "make_decode_step", "make_prefill_step", "make_train_step",
           "meta_model", "named_tree", "opt_tree", "params_tree", "place",
           "place_model", "place_opt_state", "place_tree", "spmd"]
