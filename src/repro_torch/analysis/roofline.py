"""Roofline of the dry run on one H100: the port of
``repro.analysis.roofline``.

Per (arch x shape x mesh) cell, per device:

    compute term    = FLOPs / bf16 peak + lane operations / fp32 rate
    memory term     = bytes / HBM bandwidth
    collective term = bytes over "model" / NVLink bandwidth
                      + bytes over "data" or "pod" / InfiniBand bandwidth
                      (0 on the one-card mesh)

What is counted, and how (``count_costs``): the step runs once on
``meta`` tensors (``launch.steps.lower_cell``) under a
``TorchDispatchMode`` that sees every aten op.

* FLOPs of the matmul family by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ...), as XLA's ``cost_analysis``
  counts its dots;
* bytes as each aten op's inputs plus its outputs, each once: the port's
  unfused traffic, which is what it launches (a view moves nothing, an
  ``empty`` writes nothing, a gather reads the rows it takes and an
  indexed store writes the rows it stores).  XLA fuses elementwise
  chains and counts a fusion's operands once, so its count of the same
  step is lower;
* each model kernel's work (the paged decode attention, the flash
  attention forward and backward, the WKV6 and SSD scans forward and
  backward) by the formulas below, which its wrapper's ``meta`` branch
  charges (``charge``) instead of launching: the inputs read once, the
  outputs written once, the products the kernel's arithmetic needs.
  ``chip_smoke.py`` computes the same kernels' bounds with the same
  formulas, so a kernel's work is counted one way whatever implements it.
  On ``meta`` a sequence's length has no value, so the paged kernel
  charges every page of its block table, as XLA's einsum over all S
  slots does (a run on the card at pos = S - 1 reads the same);
* the live bytes of the storages the step creates, each from the op
  that first returns it until the storage is freed (views, ``detach``
  aliases, the tensors autograd saves and the gradients it accumulates
  hold theirs), whose peak is the record's ``temp_bytes``;
* on a production mesh (``launch.mesh.device_mesh``: the parameters,
  inputs and optimizer state are DTensors over a ``fake`` process group,
  this process rank 0), one device's program: the mode passes every op
  on DTensors back to DTensor (``NotImplemented``), which propagates the
  shardings, inserts the collectives and runs the op on rank 0's shards,
  and the mode counts those local ops.  The tensors DTensor's
  propagation computes at the global shape are ``FakeTensor``s and are
  not counted.  Each ``_c10d_functional`` collective is counted as
  collective bytes, not HBM bytes, by kind and by mesh axis (its group's
  axis, ``name_groups``), under the JAX package's convention: the
  result's bytes (the gathered array for an all-gather, the shard for a
  reduce-scatter); waiting on one moves nothing.

The port runs its layers in a Python loop, so the count covers every
layer and ``cell_costs`` adds no scan correction; ``probes`` (one
application of each repeated group's body, ``launch.steps.group_probes``)
are recorded for their GFLOPs, and a test holds them to the difference
between the step at L layers and at L - 1.

Hardware model: one NVIDIA H100 SXM, spec-sheet figures (below).  No
figure of the JAX package's TPU carries over.

The JAX package's ``collective_bytes`` parses the collectives out of a
partitioned program's HLO text; the counting mode sees them as they are
issued instead.  Not ported: ``_while_trip_counts`` reads the trip counts
of the HLO's ``while`` loops, and the port has no ``while`` (its layers
are a Python loop); ``normalize_cost_analysis`` has nothing to normalize
here.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import weakref
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM data sheet (dense rates, no sparsity, at the 700 W
# limit): bf16/fp16 tensor cores
PEAK_FLOPS = 989e12
# the same data sheet: fp32 outside the tensor cores, the rate of the
# scans' state updates and of 32-bit integer lanes
LANE_OPS = 67e12
# the same data sheet: HBM3 bandwidth and capacity
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# the same data sheet: NVLink 4, 900 GB/s a card to the others of an HGX
# node, 450 GB/s each way: the "model" axis, inside a node
NVLINK_BW = 450e9
# NVIDIA DGX H100 data sheet: one 400 Gb/s ConnectX-7 InfiniBand port a
# GPU, 50 GB/s: the "data" and "pod" axes, across nodes
IB_BW = 50e9


def bound(n_bytes: float, ops: float, rate: float = PEAK_FLOPS
          ) -> Tuple[float, str]:
    """Least time in ms for work that moves ``n_bytes`` through HBM and
    does ``ops`` operations at ``rate``, and which of the two bounds it
    (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = n_bytes / HBM_BW, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------
# the model kernels' work: (FLOPs at the tensor-core rate, bytes, lane
# operations at the fp32 rate)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Work:
    flops: float = 0.0
    bytes: float = 0.0
    lane_ops: float = 0.0


def paged_work(live: Sequence[int], H: int, Hk: int, dh: int,
               page_size: int, q_bytes: int = 2, kv_bytes: int = 2,
               lse: bool = False) -> Work:
    """The paged decode attention over sequences with ``live`` keys each:
    the live keys and values once (``kv_bytes`` an element: 2 for bf16,
    1 for the int8 cache), q and the output (``q_bytes``), the table's
    live entries and the length (4 bytes each), and the fp32 log-sum-exp
    of each query head where it is stored; 4 FLOPs a (key, query head,
    channel): the score and the P.V product."""
    n_bytes = flops = 0
    for n in live:
        n_bytes += (2 * kv_bytes * n * Hk * dh + 2 * q_bytes * H * dh
                    + 4 * -(-n // page_size) + 4 + (4 * H if lse else 0))
        flops += 4 * n * H * dh
    return Work(flops=flops, bytes=n_bytes)


@functools.lru_cache(maxsize=None)
def seen_pairs(T: int, S: int, window=None) -> int:
    """(query, key) pairs the causal mask, and the window, leave: query i
    sits at position i + S - T."""
    off = S - T
    return sum(max(0, min(S, i + off + 1)
                   - (0 if window is None else max(0, i + off - window + 1)))
               for i in range(T))


def flash_work(B: int, T: int, S: int, H: int, Hk: int, dh: int,
               pairs: float, elem_bytes: int = 2,
               lse: bool = False) -> Work:
    """The attention forward over ``pairs`` (query, key) pairs a (batch,
    head): q and the output [B, T, H, dh], k and v [B, S, Hk, dh] once
    (and the fp32 log-sum-exp [B, H, T] where it is written); 4 FLOPs a
    pair and channel (QK^T and P.V)."""
    n_bytes = elem_bytes * (2 * B * T * H * dh + 2 * B * S * Hk * dh)
    if lse:
        n_bytes += 4 * B * H * T
    return Work(flops=4 * B * pairs * H * dh, bytes=n_bytes)


def flash_bwd_work(B: int, T: int, S: int, H: int, Hk: int, dh: int,
                   pairs: float, elem_bytes: int = 2) -> Work:
    """The attention backward: q, out, dout, dq [B, T, H, dh] and k, v,
    dk, dv [B, S, Hk, dh] once; 10 FLOPs a pair and channel (QK^T again,
    dP = dout V^T, dV, dQ, dK)."""
    return Work(flops=10 * dh * H * B * pairs,
                bytes=elem_bytes * (4 * B * T * H * dh + 4 * B * S * Hk * dh))


def wkv6_work(B: int, T: int, H: int, dh: int, elem_bytes: int = 2,
              carried: bool = False) -> Work:
    """The WKV6 scan: r, k, v and the output (``elem_bytes``), logw fp32,
    u, the final state (and a carried one) fp32; 4 fp32 lane operations a
    state element a step (one FMA for r.S, one for the update)."""
    n = B * T * H * dh
    n_bytes = (4 * elem_bytes * n + 4 * n + 4 * H * dh
               + 4 * B * H * dh * dh * (2 if carried else 1))
    return Work(bytes=n_bytes, lane_ops=4 * dh * dh * T * H * B)


def ssd_work(B: int, T: int, H: int, dh: int, N: int, elem_bytes: int = 2,
             carried: bool = False) -> Work:
    """The SSD scan: x and y (``elem_bytes``), dt fp32, B_ and C_, A, the
    final state (and a carried one) fp32; 4 fp32 lane operations a state
    element a step (one FMA for the update, one for y)."""
    n = B * T * H * dh
    n_bytes = (2 * elem_bytes * n + 4 * B * T * H + 2 * elem_bytes * B * T * N
               + 4 * H + 4 * B * H * dh * N * (2 if carried else 1))
    return Work(bytes=n_bytes, lane_ops=4 * dh * N * T * H * B)


def wkv6_bwd_flops(B: int, T: int, H: int, dh: int) -> float:
    """The chunked backward's matrix products, each counted once: per
    (b, h) and chunk of C = 64 steps the two state increments, dr's,
    dk's and dv's inter-chunk terms (2 C dh^2 each) and five causal
    C x C x dh products (D = do v^T, dr's and dk's intra-chunk terms, the
    scores A and A^T do)."""
    C, nc = 64, -(-T // 64)
    return B * H * nc * (12 * C * dh * dh + 5 * C * C * dh)


def ssd_bwd_flops(B: int, T: int, H: int, dh: int, N: int) -> float:
    """The same for the SSD backward: per (b, h) and chunk the two state
    increments, dC_'s, dx's and dB_'s inter-chunk terms (2 C dh N each),
    the causal dy x^T and (C B^T * L) dy (C^2 dh each) and the two W
    products with B_ and C_ (C^2 N each)."""
    C, nc = 64, -(-T // 64)
    return B * H * nc * (10 * C * dh * N + 2 * C * C * dh + 2 * C * C * N)


def wkv6_bwd_work(B: int, T: int, H: int, dh: int,
                  elem_bytes: int = 2) -> Work:
    """The WKV6 backward: r, k, v, do, dr, dk, dv (``elem_bytes``),
    logw and dlogw fp32, u and du; the chunked form's products."""
    n = B * T * H * dh
    return Work(flops=wkv6_bwd_flops(B, T, H, dh),
                bytes=7 * elem_bytes * n + 2 * 4 * n + 2 * 4 * H * dh)


def ssd_bwd_work(B: int, T: int, H: int, dh: int, N: int,
                 elem_bytes: int = 2) -> Work:
    """The SSD backward: x, dy, dx (``elem_bytes``), dt and ddt fp32,
    B_, C_ and their gradients, A and dA; the chunked form's products."""
    n = B * T * H * dh
    return Work(flops=ssd_bwd_flops(B, T, H, dh, N),
                bytes=(3 * elem_bytes * n + 2 * 4 * B * T * H
                       + 4 * elem_bytes * B * T * N + 2 * 4 * H))


# ----------------------------------------------------------------------
# counting a step on meta tensors
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    lane_ops: float = 0.0
    #: name -> {"calls", "flops", "bytes", "lane_ops"} of the kernels
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: aten op -> bytes it moved (the kernels' under their names)
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0  # peak of the live tensors the step created
    output_bytes: int = 0  # the step's outputs that are not arguments
    alias_bytes: int = 0  # the step's outputs that are arguments
    #: collective bytes: kind ("all-reduce", ...) -> bytes, and mesh
    #: axis -> bytes
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_by_kind.values())

    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS + self.lane_ops / LANE_OPS

    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    def collective_s(self) -> float:
        """The "model" axis's bytes over NVLink, every other axis's over
        InfiniBand."""
        return sum(b / (NVLINK_BW if ax == "model" else IB_BW)
                   for ax, b in self.coll_by_axis.items())


_ACTIVE: List["_Counter"] = []
# process group name -> mesh axis name, of the mesh ``launch.mesh.
# device_mesh`` made (a group it did not name is its own axis)
_GROUP_AXES: Dict[str, str] = {}


def name_groups(group_axes: Dict[str, str]) -> None:
    """Set which mesh axis each process group (by name) is."""
    _GROUP_AXES.clear()
    _GROUP_AXES.update(group_axes)


# the functional collectives DTensor issues, by the JAX package's kinds
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"), ("permute", "collective-permute"))


def _collective(func, args, kwargs) -> Tuple[Any, Any]:
    """(kind, group name) of a functional collective; (None, None) for
    an op of those namespaces that moves nothing (``wait_tensor``)."""
    name = func._overloadpacket.__name__
    kind = next((k for stem, k in _KINDS if name.startswith(stem)), None)
    if kind is None:
        return None, None
    names = [a.name for a in func._schema.arguments]
    i = names.index("group_name")
    return kind, kwargs.get("group_name", args[i] if i < len(args) else None)

# ops that move no bytes: they allocate (``empty``), reshape without a
# copy (``_unsafe_view``, not marked a view in its schema) or describe
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten._unsafe_view,
               torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh,
               torch.ops.aten.sym_size, torch.ops.aten.sym_stride,
               torch.ops.aten.sym_numel, torch.ops.aten.sym_storage_offset,
               torch.ops.aten.is_same_size}
# a gather reads the rows it takes: the output once read, once written
_GATHERS = {torch.ops.aten.index, torch.ops.aten.embedding,
            torch.ops.aten.index_select, torch.ops.aten.gather}
# an indexed store reads and writes the rows it stores (its values) and
# not the tensor it stores into
_STORES = {torch.ops.aten.index_put_, torch.ops.aten.index_put,
           torch.ops.aten._index_put_impl_}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of every aten op it sees, and
    takes the kernels' charges (``charge``)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        self.costs = Costs()
        self.live = 0
        self._storages: set = set()  # the live storages' keys
        self._dtensor, self._fake = DTensor, FakeTensor

    def charge(self, name: str, work: Work) -> None:
        c = self.costs
        c.flops += work.flops
        c.bytes_accessed += work.bytes
        c.lane_ops += work.lane_ops
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0, "lane_ops": 0.0})
        c.by_op[name] = c.by_op.get(name, 0.0) + work.bytes
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        k["lane_ops"] += work.lane_ops

    def _freed(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def _live(self, ins, outs) -> None:
        """Charge each storage that an op's outputs bring into being (not
        an input's, nor one already live) its bytes until the storage
        itself is freed: a view, a ``detach`` alias, a tensor that
        autograd saves or a gradient it accumulates holds the storage
        after the op's own output object is gone."""
        given = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in given or key in self._storages:
                continue
            n = s.nbytes()
            self._storages.add(key)
            self.live += n
            self.costs.temp_bytes = max(self.costs.temp_bytes, self.live)
            weakref.finalize(s, self._freed, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in outs):
            return out  # sharding propagation's global-shape shadow
        packet = func._overloadpacket
        c = self.costs
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind, group = _collective(func, args, kwargs)
            if kind is not None:
                n = sum(map(_nbytes, outs))
                axis = _GROUP_AXES.get(group, group)
                c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + n
                c.coll_by_axis[axis] = c.coll_by_axis.get(axis, 0.0) + n
                self._live(ins, outs)
            return out
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or packet in _NO_TRAFFIC:
            n_bytes = 0
        elif packet in _GATHERS:
            n_bytes = sum(2 * _nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in _tensors(args[1:]))
        elif packet in _STORES:
            n_bytes = sum(_nbytes(t) for t in _tensors(args[1:]))
            n_bytes += _nbytes(args[2])  # the stored rows, written
        elif packet is torch.ops.aten.copy_:
            n_bytes = 2 * _nbytes(args[1])
        else:
            n_bytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c.bytes_accessed += n_bytes
        if n_bytes:
            op = str(packet).split(".", 1)[-1]
            c.by_op[op] = c.by_op.get(op, 0.0) + n_bytes
        if not func.is_view:  # new tensors: live until collected
            self._live(ins, outs)
        return out


def charge(name: str, work: Work) -> None:
    """Add a kernel's ``work`` to the innermost ``count_costs`` running,
    if any (a wrapper's ``meta`` branch calls it in place of a launch)."""
    if _ACTIVE:
        _ACTIVE[-1].charge(name, work)


def count_costs(fn: Callable, *args, **kwargs) -> Tuple[Costs, Any]:
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors) under the
    counting mode: (its Costs, its result).  ``output_bytes`` and
    ``alias_bytes`` split the result's tensors into new ones and
    arguments written in place (a DTensor's by its shard)."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    given = {id(t) for t in _tensors((args, kwargs))}
    for t in {id(t): t for t in _tensors(out)}.values():
        n = _nbytes(t.to_local() if isinstance(t, counter._dtensor) else t)
        if id(t) in given:
            counter.costs.alias_bytes += n
        else:
            counter.costs.output_bytes += n
    return counter.costs, out


def cell_costs(cfg, shape, costs: Costs, probes: Iterable[Tuple[str, int,
                                                                Costs]],
               n_chips: int = 1) -> Dict[str, Any]:
    """The roofline record of one dry-run cell from the step's ``costs``
    and ``probes`` [(group, repeat, Costs of one application of its
    body)], with the JAX package's keys where their meaning carries."""
    compute_s, memory_s = costs.compute_s(), costs.memory_s()
    collective_s = costs.collective_s()
    terms = {"compute": compute_s * 1e3, "memory": memory_s * 1e3,
             "collective": collective_s * 1e3}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: 6 N D for train, 2 N D forward-only (per device)
    n_params = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_params * tokens / n_chips
    useful = model_flops / costs.flops if costs.flops else 0.0
    bound_s = max(compute_s, memory_s, collective_s)
    return {
        "per_device": True,
        "gflops": costs.flops / 1e9,
        "lane_gops": costs.lane_ops / 1e9,
        "gbytes": costs.bytes_accessed / 1e9,
        "collective_mb": costs.coll_bytes / 1e6,
        "collective_by_kind_mb": {k: v / 1e6
                                  for k, v in costs.coll_by_kind.items()},
        "collective_by_axis_mb": {k: v / 1e6
                                  for k, v in costs.coll_by_axis.items()},
        "terms_ms": terms,
        "dominant": dominant,
        "model_gflops_per_device": model_flops / 1e9,
        "useful_flops_ratio": useful,
        "roofline_fraction": (compute_s / bound_s) if bound_s else 0.0,
        "step_time_bound_ms": bound_s * 1e3,
        "kernels": costs.kernels,
        "top_ops_gbytes": {k: v / 1e9 for k, v in sorted(
            costs.by_op.items(), key=lambda kv: -kv[1])[:8]},
        "probes": [{"group": g, "repeat": repeat,
                    "body_gflops": pc.flops / 1e9,
                    "body_coll_mb": pc.coll_bytes / 1e6}
                   for g, repeat, pc in probes],
    }


# ----------------------------------------------------------------------
# report generation from runs/dryrun_torch/*.json
# ----------------------------------------------------------------------
def load_records(run_dir: str) -> List[dict]:
    out = []
    for fn in sorted(os.listdir(run_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(run_dir, fn)) as f:
                out.append(json.load(f))
    return out


def table(records: Iterable[dict], mesh: str = "1x1",
          variant: str = "base") -> str:
    rows = [r for r in records
            if r.get("mesh") == mesh and r.get("roofline")
            and r.get("variant", "base") == variant]
    hdr = (f"| arch | shape | compute ms | memory ms | collective ms | "
           f"dominant | useful | roofline frac | HBM GiB/dev |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        rl = r["roofline"]
        t = rl["terms_ms"]
        hbm = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]) \
            / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute']:.2f} | "
            f"{t['memory']:.2f} | {t['collective']:.2f} | "
            f"{rl['dominant']} | {rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.2f} | {hbm:.2f} |")
    return "\n".join(lines)


__all__ = ["Costs", "HBM_BW", "HBM_BYTES", "IB_BW", "LANE_OPS", "NVLINK_BW",
           "PEAK_FLOPS", "Work", "bound", "cell_costs", "charge",
           "count_costs", "flash_bwd_work", "flash_work", "load_records",
           "name_groups", "paged_work", "seen_pairs", "ssd_bwd_flops",
           "ssd_bwd_work", "ssd_work", "table", "wkv6_bwd_flops",
           "wkv6_bwd_work", "wkv6_work"]
