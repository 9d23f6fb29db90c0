"""The dry run on one H100: the port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, build the model on
``meta`` (no weight drawn, nothing allocated), take the specs of every
argument over a mesh (``distributed.sharding``), and record:

* ``--mesh card`` (the one-card mesh, 1 x 1): the argument bytes
  (parameters, the AdamW state, the batch or the caches), the step's
  output and temp bytes (the peak of the live tensors it creates), whether
  they fit the card's 80 GB, and the roofline of the step counted on
  ``meta`` (``analysis.roofline.count_costs``: FLOPs, bytes and each model
  kernel's work) on H100 spec-sheet constants;
* ``--mesh pod`` / ``multipod`` / ``both`` (``launch.mesh.
  make_production_mesh``: 32 x 8 and 2 x 32 x 8): the same per device.
  The cell runs under ``launch.mesh.device_mesh`` (a ``fake`` process
  group of 256 or 512 ranks, this process rank 0), its parameters,
  inputs and AdamW state DTensors placed by the specs, so the count is
  rank 0's program as DTensor partitions it, with its collective bytes
  by kind and mesh axis.  The record also holds the specs and the
  rules' replication fallbacks; the argument bytes are each leaf's
  shard under its spec (the AdamW state ZeRO-sharded).

A count, not a measurement: nothing runs on a card, so this runs on any
machine.  ``python -m repro_torch.launch.dryrun [--arch A[,B]] [--shape
S[,T]] [--variant base|kv_int8|...] [--mesh card|pod|multipod|both]
[--no-probes] [--out DIR]`` writes one JSON record a cell to
``runs/dryrun_torch/`` (``<arch>__<shape>__<mesh>[__<variant>].json``);
``--table`` prints the records of ``--mesh`` as a table (``summary``),
and ``analysis.roofline.table`` gives the JAX package's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List

from ..analysis import roofline
from ..configs.base import SHAPES, all_archs, get_arch, shape_applicable
from ..distributed import sharding as shard_rules
from . import steps
from .mesh import (MeshSpec, device_mesh, make_production_mesh,
                   make_smoke_mesh)

RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "runs", "dryrun_torch")
MESHES = {"card": [make_smoke_mesh()],
          "pod": [make_production_mesh()],
          "multipod": [make_production_mesh(multi_pod=True)]}
MESHES["both"] = MESHES["pod"] + MESHES["multipod"]


def argument_bytes(arg_specs: Dict[str, Any], shardings: Dict[str, Any],
                   mesh: MeshSpec) -> int:
    """Bytes of one device's share of every argument: each leaf's shape
    under its spec (``sharding.local_shape``) times its element size."""
    total = 0
    for name, tree in arg_specs.items():
        specs = {tuple(p): s for p, s in shard_rules.items(shardings[name])}
        for path, t in shard_rules.items(tree):
            local = shard_rules.local_shape(tuple(t.shape),
                                            specs[tuple(path)], mesh)
            total += math.prod(local) * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh: MeshSpec, *,
             out_dir: str = RUNS_DIR, probes: bool = True,
             variant: str = "base") -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    variants = frozenset(v for v in variant.split("+") if v != "base")
    with contextlib.ExitStack() as stack:
        if mesh.size > 1:  # one device's share, over a fake process group
            stack.enter_context(device_mesh(mesh))
        record = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
                  "variant": variant,
                  **_count_cell(cfg, shape, mesh, variants, probes)}
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh.name}" + \
        (f"__{variant}" if variant != "base" else "")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def _count_cell(cfg, shape, mesh: MeshSpec, variants: frozenset,
                probes: bool) -> Dict[str, Any]:
    t0 = time.time()
    lowered, _ = steps.lower_cell(cfg, shape, mesh, variants=variants)
    t_lower = time.time() - t0
    record: Dict[str, Any] = {
        "n_devices": mesh.size,
        "lower_s": round(t_lower, 2),
        "memory": {"argument_bytes": argument_bytes(
            lowered.arg_specs, lowered.shardings, mesh)},
        "replicated": shard_rules.replicated(lowered.arg_specs["params"],
                                             mesh),
        "specs": lowered.shardings,
    }
    t0 = time.time()
    costs, _ = roofline.count_costs(lowered.fn, *lowered.args)
    record["count_s"] = round(time.time() - t0, 2)
    mem = record["memory"]
    mem.update(output_bytes=costs.output_bytes, temp_bytes=costs.temp_bytes,
               alias_bytes=costs.alias_bytes)
    record["fits_80gb"] = (mem["argument_bytes"] + mem["temp_bytes"]
                           <= roofline.HBM_BYTES)
    body = []
    if probes:
        for gname, repeat, probe in steps.group_probes(cfg, shape, mesh,
                                                       variants=variants):
            body.append((gname, repeat,
                         roofline.count_costs(probe.fn, *probe.args)[0]))
    record["roofline"] = roofline.cell_costs(
        steps.apply_variants(cfg, variants), shape, costs, body, mesh.size)
    return record


def summary(records: List[dict], variant: str = "base",
            mesh: str = "1x1") -> str:
    """The records of ``variant`` on ``mesh`` as a markdown table, a row
    an arch and a column a shape; a cell: argument GB a device, whether
    argument and temp bytes fit 80 GB, the compute and memory terms in
    ms (and the collective term on a production mesh), the dominant one
    and the useful-FLOPs ratio."""
    cells = {(r["arch"], r["shape"]): r for r in records
             if r.get("mesh") == mesh and r.get("roofline")
             and r.get("variant", "base") == variant}
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|" + "---|" * (len(SHAPES) + 1)]
    for arch in sorted({a for a, _ in cells}):
        row = []
        for shape in SHAPES:
            r = cells.get((arch, shape))
            if r is None:
                row.append("-")
                continue
            rl, t = r["roofline"], r["roofline"]["terms_ms"]
            coll = f" / {t['collective']:.3f}" if mesh != "1x1" else ""
            row.append(f"{r['memory']['argument_bytes'] / 1e9:.3f} GB "
                       f"{'fits' if r['fits_80gb'] else 'over'}; "
                       f"{t['compute']:.3f} / {t['memory']:.3f}{coll} "
                       f"{rl['dominant'][0]}; "
                       f"{rl['useful_flops_ratio']:.3f}")
        lines.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="card")
    ap.add_argument("--out", default=RUNS_DIR)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out of each mesh of --mesh "
                    "and stop")
    args = ap.parse_args(argv)
    if args.table:
        for mesh in MESHES[args.mesh]:
            print(summary(roofline.load_records(args.out), args.variant,
                          mesh.name))
        return 0
    archs = all_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh in MESHES[args.mesh]:
                tag = f"{arch} x {shape_name} x {mesh.name}"
                try:
                    rec = run_cell(arch, shape_name, mesh, out_dir=args.out,
                                   probes=not args.no_probes,
                                   variant=args.variant)
                except Exception as e:  # report every cell, then fail
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}")
                    traceback.print_exc()
                    continue
                if "skipped" in rec:
                    print(f"[skip] {tag}: {rec['skipped']}")
                    continue
                gb = rec["memory"]["argument_bytes"] / 1e9
                terms = rec["roofline"]["terms_ms"]
                print(f"[ ok ] {tag}: count {rec['count_s']}s argument "
                      f"{gb:.3f} GB fits {rec['fits_80gb']} compute "
                      f"{terms['compute']:.3f}ms memory "
                      f"{terms['memory']:.3f}ms collective "
                      f"{terms['collective']:.3f}ms -> "
                      f"{rec['roofline']['dominant']}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        return 1
    print("\nAll dry-run cells counted.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
