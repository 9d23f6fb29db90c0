#!/usr/bin/env python3
"""Time YCSB-C and YCSB-A on P-CLHT and P-ART with the port of two
checkouts of the repository, in turns, on one card.

    python3 tools/readback_ab.py BEFORE AFTER [--n-clht N] [--n-art N]
                                 [--reps R] [--seed S]

BEFORE and AFTER are checkouts (for example the parent commit unpacked
with ``git archive`` into a gitignored directory, and ``.``).  Each run
is a child process that imports ``repro_torch`` from its tree's ``src``
(building that tree's kernels there), loads P-CLHT (2^20 keys) and
P-ART (2^19) on the card as ``chip_smoke.py`` does, reads once through
the kernel path so the snapshot's tables are on the card, then times R
YCSB-C passes over the loaded keys and one YCSB-A pass: host clock
around each pass, with a device synchronise before the clock stops.
The trees run in the order BEFORE, AFTER, AFTER, BEFORE.  Prints the
card's name and power limit, each run's kops/s and, per tree and
workload, the median over its runs.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PLAN_OPS = 4096


def one(tree: Path, n_clht: int, n_art: int, reps: int, seed: int) -> dict:
    """kops/s of each workload with ``tree``'s port."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.api import Plan, open_index
    from repro_torch.core.ycsb import PhaseExecutor, generate

    def timed(index, ops) -> tuple:
        ex = PhaseExecutor(index, batch_lookups=True, max_batch=PLAN_OPS)
        t0 = time.perf_counter()
        done = ex.run(ops)
        torch.cuda.synchronize()
        return done, len(ops) / (time.perf_counter() - t0) / 1e3

    out = {}
    for tag, kind, n in (("P-CLHT", "clht", n_clht), ("P-ART", "art", n_art)):
        session = open_index(kind)
        load = generate("C", n, n, seed=seed)
        done, _ = timed(session.index, load.load_ops)
        if done["acked"] != n:
            raise SystemExit(f"{tag}: an insert was not acknowledged")
        keys = np.fromiter((k for _, k, _ in load.run_ops[:PLAN_OPS]),
                           np.int64)
        plan = Plan.from_arrays(np.zeros(keys.size, np.int32), keys,
                                np.zeros(keys.size, np.int64))
        if session.execute(plan, force_kernel=True).found != keys.size:
            raise SystemExit(f"{tag}: a loaded key did not read back")
        rates = []
        for _ in range(reps):
            done, r = timed(session.index, load.run_ops)
            if done["found"] != len(load.run_ops):
                raise SystemExit(f"{tag} YCSB-C: a lookup missed")
            rates.append(r)
        out[f"{tag} YCSB-C"] = rates
        mix_a = generate("A", n, max(n // 4, PLAN_OPS), seed=seed)
        done, r = timed(session.index, mix_a.run_ops)
        if done["found"] != done["lookup"] or done["acked"] != done["insert"]:
            raise SystemExit(f"{tag} YCSB-A: a lookup missed or an insert "
                             "was not acknowledged")
        out[f"{tag} YCSB-A"] = [r]
        del session
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--n-clht", type=int, default=1 << 20)
    ap.add_argument("--n-art", type=int, default=1 << 19)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.n_clht, args.n_art,
                             args.reps, args.seed)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees: BEFORE AFTER")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("readback_ab: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = ("before", "after")
    runs = {name: {} for name in names}
    for i in (0, 1, 1, 0):
        tree = args.trees[i].resolve()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(tree), "--n-clht", str(args.n_clht), "--n-art",
             str(args.n_art), "--reps", str(args.reps), "--seed",
             str(args.seed)],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            raise SystemExit(f"readback_ab: the {names[i]} run failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{names[i]} ({tree}): " + "; ".join(
            f"{k} " + ", ".join(f"{r:.3f}" for r in v)
            for k, v in got.items()) + " kops/s", flush=True)
        for k, v in got.items():
            runs[names[i]].setdefault(k, []).extend(v)
    for k in runs["before"]:
        b, a = (statistics.median(runs[n][k]) for n in names)
        print(f"{k}: median before {b:.3f}, after {a:.3f} kops/s "
              f"(after/before {a / b:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
