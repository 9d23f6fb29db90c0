#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--n-clht 1048576] [--n-art 524288]
                          [--n-hot 262144] [--n-masstree 262144]
                          [--n-bwtree 32768] [--n-cceh 32768]
                          [--n-fastfair 65536] [--n-level 16384]
                          [--seed 0]

Each path is a YCSB workload of 4096-op plans through
``repro_torch.api.open_index``.  Five paths drive one of RECIPE's
converted indexes each:

* P-CLHT, whose read waves run the chained probe kernel
  (``src/repro_torch/csrc/probe.cu``), and P-ART and P-HOT, whose read
  waves run the radix-descent kernel (``csrc/art_descend.cu``, 8-bit
  and 4-bit units): Load A, a powerfail crash after which every loaded
  key reads back, YCSB-C (every lookup found with ``value_of(key)``),
  YCSB-A (acked writes and found reads as the mix implies), 8 YCSB-C
  plans with fingerprints off, and 4096 sampled keys through the kernel
  path against scalar lookups (for the radix trees with key 0 and keys
  of 2^63 and above);
* P-Masstree and P-BwTree, whose lookups and range scans run the
  sorted-run search kernel (``csrc/scan_window.cu``): Load A, powerfail
  and read-back, YCSB-C (windows of 1), YCSB-E0 (pure scans, windows of
  128, every result equal to the scalar ``scan``), and for P-Masstree a
  short YCSB-E (5% inserts; its scan waves mostly run scalar, below the
  stale-snapshot floor).

The sixth, the scale-out path, drives ``open_index(kind, shards=S)``:
every plan is routed and sorted by shard in one launch of the partition
kernel (``csrc/shard_route.cu`` ``shard_partition``; the routing
kernel of the same source, ``shard_route``, answers ``route``, which no
path calls: where the smoke needs a key's shard it asks the numpy
``route_ref``):

* P-CLHT in 8 shards (``--n-clht`` keys, hash routing): Load A, YCSB-C
  through the mesh read path (all 8 shards' sorted runs searched in one
  launch of ``csrc/scan_window.cu`` with a shard axis, the plan's keys
  and shard ids left on the card) and through the per-shard path (the
  mean ``route_ns`` of each printed), the same plans on the unsharded
  P-CLHT of the first path, YCSB-A, a crash injected inside one shard's
  group commit (the siblings serve the plan's new values with no
  replay; the shard is power-failed and its sub-plan replayed; every
  acknowledged key reads back), and 4 client streams of overlapping YCSB-A plans through
  ``StreamDriver``, whose admission runs the conflict kernel
  (``csrc/conflict_any.cu``): some plans defer, and every ticket's
  results equal a sequential oracle applied in tick order;
* CCEH unsharded and in 8 shards (``--n-cceh``): Load A, YCSB-C and
  YCSB-A, with the reference's two columns for P-CLHT and CCEH
  (modeled ``critical_ns`` and wall kops/s, and 8-shard / 1-shard);
* FAST&FAIR in 4 shards (``--n-fastfair``, prefix routing on key bits
  59-58, since YCSB keys lie below 2^60): YCSB-E0 scans merged across
  shards, each equal to the merge of every shard's scalar ``scan``;
  Level hashing unsharded (``--n-level``): YCSB-C.

The seventh, the serving path, runs ``repro_torch.serving.Server`` over
the port's ``LM`` at the full width of Qwen2-0.5B (24
layers, d_model 896, 14 heads over 2 KV heads, vocabulary 151,936,
bf16 weights drawn from ``--seed``): prefill attention on the flash
kernel (``csrc/flash_attention.cu``), decode attention on the paged
kernel (``csrc/paged_attention.cu``), block-table translations on the
probe kernel, prefix probes on the radix-descent kernel and the
post-crash prefix warmup on the sorted-run search kernel.  16 requests
of 256-512 tokens sharing a 128-token prefix, in 2 client sessions,
32 new tokens each, at most 8 running: the first 8 drain, the server
power-fails and recovers (warm prefixes restored and hit), the last 8
drain; then the same workload on a fresh server with pipelined ticks
(tokens equal to the blocking run's).  Steady decode ticks move no PMem
loads, the plain attention versions are never called on the path, and
one request's prefill logits and 4 decode steps are recomputed on the
CPU with the plain versions and the same weights.

The eighth, the RWKV serving path, runs the same workload on RWKV6-7B at
full width (32 layers, d_model 4096, 64 heads of 64, d_ff 14336,
vocabulary 65,536, bf16 from ``--seed``), plus prompts of exactly 32 and
64 tokens (its layer and head counts) in the last phase: time mixing on
the WKV6 kernel (``csrc/wkv6.cu``), 32 launches per prefill and per
decode step, the index kernels as above, no plain version on the path.
Its CPU check takes the 32-token prompt.

The ninth, the Mamba path, runs Jamba-1.5-Large's Mamba mixers at full
width (d_model 8192, d_in 16384, 256 heads of 64, d_state 16, bf16 from
``--seed``): the mixer half of the block (norm, mixer, residual) for the
7 Mamba sublayers of one superblock, a prefill at B = 1, T = 4096 and
one at B = 2, T = 3001 (per-batch B_ and C_, a ragged last chunk), then
32 decode steps from the carried states: the SSD scan on its kernel
(``csrc/ssd.cu``), 7 launches per prefill and per decode step, no plain
version on the path.  Its CPU check runs one layer in fp32 on both
sides over a 256-token prompt and 4 decode steps.

The tenth, the hybrid serving path, runs the serving workload on
Jamba-1.5-Large at ``reduced()`` (8 sublayers: Mamba, attention, MLP and
MoE; one full-width superblock is 90 GB in bf16, more than the card),
plus prompts of 1 and 8 tokens (the lengths at which the reference's
cache padding breaks on Mamba state): the SSD kernel 7 times per
prefill and per decode step, both attention kernels, the index kernels,
no plain version on the path.  Its CPU check takes the longest prompt,
in fp32 on both sides.

The eleventh, the tag path, drives the 32-bit tag data plane
(``kernels/clht_probe`` ``tag_lookup``): 2^19 keys in a chained table of
2^18 buckets built from ``--seed``, one wave of 4096 queries (hits,
misses, query 0 and two keys whose tags collide) through the tag probe
kernel (``csrc/clht_probe.cu`` ``tag_probe``, which walks each query's
chain itself), every answer equal to a numpy reading.  After the path's
counts are read, the wave's device operations are counted with the
profiler; the window entry of that source (``clht_probe``), which no
path runs, is checked in phase 4.

The twelfth, the matrix path, drives the adversarial workload matrix
(``repro_torch.data.workloads``) and RECIPE's own crash testing
(``repro_torch.core.crash_testing``) on indexes opened on the card with
fingerprints on.  Every count is held against ``replay``, the
dict/sorted-dict oracle, and every final state against its model:

* (a) YCSB-F with Zipfian targets (theta 0.99, YCSB's constant) on
  P-CLHT, 2^18 keys loaded and 2^16 run ops through ``run_workload`` in
  4096-op plans, then on a freshly loaded P-CLHT through the buffered
  engine: both runs' kops/s and the plans' waves per plan (the hottest
  key's read-modify-writes force waves);
* (b) YCSB-A over clustered string keys (``keyspace="string"``, theta
  0.99) on P-ART, 2^17 keys and 2^15 run ops: the radix descent;
* (c) YCSB-E over string keys (theta 0.9) on P-Masstree, 2^14 keys and
  4096 run ops, sized so that ``replay``'s scans (a sort of the live
  keys each) take some 10 s of host time: the sorted-run search;
* (d) a pinned hot set (1% of 2^17 keys taking 90% of the draws) of
  YCSB-F on P-CLHT in 8 shards, 2^14 run ops in plans of 256 round robin
  over 4 client streams through ``StreamDriver``: some plans defer, the
  summed counts equal ``replay``'s and the final items ``replay`` in
  admission order (the partition and conflict kernels);
* (e) the per-store crash sweep (``run_crash_sweep``, paper §5) on the
  seven kinds the JAX package's tests sweep, with their factories on the
  card: the five converted indexes in powerfail and interrupt mode,
  FAST&FAIR and CCEH in fixed mode; buggy FAST&FAIR (``fixed=False``),
  whose split-persist bug the sweep must find again; the durability
  audit (``audit_durability``) on all eight kinds, each empty; after
  each sweep every key of its workload looked up in one plan on the
  index's kernel, equal to the scalar lookups;
* (f) one plan of (a) and one tick of (d) traced, written as a Chrome
  trace (``repro_torch.obs.trace``) and validated.

Phases, each of which exits non-zero on failure:

1. card check: a CUDA device, its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled in parallel; each
   kernel's registers, shared memory and spills as ``-Xptxas -v`` gives
   them;
3. the twelve paths, each with every kernel's launch count set to 0 just
   before it and read just after; a path fails if a kernel it runs was
   not launched; after each serving path, its CPU check and the device
   busy share of a decode step (host clock against profiled device
   time); after the Mamba path, its CPU check; the two scans' launches
   split into prefills and decode steps;
4. each kernel against its plain PyTorch version on the card, on 4096
   queries made from ``--seed`` over a table a path loaded (hits,
   misses, fingerprint near-misses, key 0, and keys of 2^63 and above
   where the index takes them): outputs must be bit-identical; the
   per-epoch packing of P-ART's and P-HOT's child entries on the
   export's whole table, bit-identical to its plain version and to the
   table the path descended; the two
   attention kernels on inputs drawn from ``--seed`` at the serving
   path's shapes, elementwise within ``ATTN_STEPS`` bf16 unit
   roundoffs, a limit that a dropped newest key breaks; the tag probe's
   window form bit-identical to its plain version and the numpy reading
   on the tag path's windows, and its whole lookup to the windows'
   gather followed by the plain probe; the partition kernel to its plain
   version and the numpy partition at 1 to 2^12 shards; the WKV6 kernel
   at RWKV6-7B's prefill (T = 512) and decode (T = 1, carried state)
   shapes, with decays down to logw = -8, within the same limit, which
   the plain version without the bonus u or
   without the carried state breaks; the SSD kernel at Jamba's prefill
   (T = 4096) and decode (T = 1, carried state; bf16, and fp32 as the
   Mamba path runs it) shapes and at the hybrid's reduced decode (fp32),
   within the same limit in bf16 and 2e-5 of the largest magnitude in
   fp32, which the plain version without the s = t term or without the
   carried state breaks; then per-launch
   times at the main path's shape (device time from the profiler, call
   time from CUDA events), beside the plain version's, a library call's
   where one computes the same function, and the least time the card
   could take (``bound_ms``).

The last two lines are the ``kernels`` JSON and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing
either.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import build  # noqa: E402
from repro_torch.api import Plan, open_index  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import (PART, PHOT, PCLHT, CrashPoint,  # noqa: E402
                              PBwTree, PMasstree, audit_durability,
                              run_crash_sweep)
from repro_torch.core.baselines import (CCEH, FastFair,  # noqa: E402
                                        LevelHashing)
from repro_torch.core.ycsb import (PhaseExecutor, generate,  # noqa: E402
                                   run_workload)
from repro_torch.data.workloads import matrix_workload, replay  # noqa: E402
from repro_torch.distributed import streams as dstreams  # noqa: E402
from repro_torch.kernels import art_probe as kart  # noqa: E402
from repro_torch.kernels.art_probe import ops as art_ops  # noqa: E402
from repro_torch.kernels import clht_probe as ktag  # noqa: E402
from repro_torch.configs import get_arch, layer_kinds  # noqa: E402
from repro_torch.kernels import conflict as kconf  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import mamba_scan as kssd  # noqa: E402
from repro_torch.kernels import paged_attention as kpaged  # noqa: E402
from repro_torch.kernels import partition as kpart  # noqa: E402
from repro_torch.kernels import probe as kprobe  # noqa: E402
from repro_torch.kernels import rwkv6_scan as kwkv  # noqa: E402
from repro_torch.kernels import scan as kscan  # noqa: E402
from repro_torch.obs import Histogram  # noqa: E402
from repro_torch.kernels.clht_probe import mix64  # noqa: E402
from repro_torch.kernels.probe import fp64, fp_partial  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models.common import norm, norm_params  # noqa: E402
from repro_torch.obs import RECORDER  # noqa: E402
from repro_torch.serving import Server  # noqa: E402
from repro_torch.serving.engine import _pad_caches  # noqa: E402

PLAN_OPS = 4096
Q = 4096  # queries per launch on the main path (one full read wave)
SLOTS = 3
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the float32 rate outside
# the tensor cores standing in for 32-bit integer lanes, and the dense
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
SOURCES = {"probe64_fp": "src/repro_torch/csrc/probe.cu",
           "probe64": "src/repro_torch/csrc/probe.cu",
           "art_descend": "src/repro_torch/csrc/art_descend.cu",
           "art_pack_entries": "src/repro_torch/csrc/art_descend.cu",
           "scan_window": "src/repro_torch/csrc/scan_window.cu",
           "scan_window_sharded": "src/repro_torch/csrc/scan_window.cu",
           "shard_route": "src/repro_torch/csrc/shard_route.cu",
           "shard_partition": "src/repro_torch/csrc/shard_route.cu",
           "conflict_any": "src/repro_torch/csrc/conflict_any.cu",
           "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "clht_probe": "src/repro_torch/csrc/clht_probe.cu",
           "tag_probe": "src/repro_torch/csrc/clht_probe.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu",
           "ssd": "src/repro_torch/csrc/ssd.cu"}
# the sharded search is scan_window with a shard axis; on the JAX
# package's mesh path it takes the place of a vmapped lower bound
# (src/repro/distributed/mesh.py:84), which is not a Pallas kernel; the
# per-epoch packing of the descent's child entries takes the place of the
# JAX package's upload of `level` and `is_leaf` beside the child table
# (its _prepare), which is not one either; the partition takes the place
# of the routing kernel and the host's stable sort by shard
# (src/repro/kernels/partition/ref.py:75, partition_ref), and the tag
# probe that of the window kernel and the gather that feeds it
# (src/repro/kernels/clht_probe/ops.py:147)
REPLACES = {"probe64_fp": "src/repro/kernels/probe/kernel.py:76",
            "probe64": "src/repro/kernels/probe/kernel.py:108",
            "art_descend": "src/repro/kernels/art_probe/kernel.py:96",
            "art_pack_entries": "src/repro/kernels/art_probe/ops.py:45",
            "scan_window": "src/repro/kernels/scan/kernel.py:79",
            "scan_window_sharded": "src/repro/kernels/scan/kernel.py:79",
            "shard_route": "src/repro/kernels/partition/kernel.py:102",
            "shard_partition": "src/repro/kernels/partition/kernel.py:102",
            "conflict_any": "src/repro/kernels/conflict/kernel.py:64",
            "paged_attention":
                "src/repro/kernels/paged_attention/kernel.py:68",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:90",
            "clht_probe": "src/repro/kernels/clht_probe/kernel.py:38",
            "tag_probe": "src/repro/kernels/clht_probe/kernel.py:38",
            "wkv6": "src/repro/kernels/rwkv6_scan/kernel.py:60",
            "ssd": "src/repro/kernels/mamba_scan/kernel.py:58"}
COUNTERS = (kprobe.LAUNCHES, kart.LAUNCHES, kscan.LAUNCHES, kpart.LAUNCHES,
            kconf.LAUNCHES, kpaged.LAUNCHES, kflash.LAUNCHES,
            ktag.LAUNCHES, kwkv.LAUNCHES, kssd.LAUNCHES)
SHARDS = 8
STREAMS = 4
STREAM_PLANS = 4  # plans per stream on the scale-out path
C_PLANS = 64  # timed YCSB-C plans per column of the reporting model
# the serving paths
SERVE_ARCH = "qwen2-0.5b"
RWKV_ARCH = "rwkv6-7b"
SERVE_REQUESTS = 16
SERVE_SESSIONS = 2
SERVE_PREFIX = 128
SERVE_PROMPT = (256, 512)
SERVE_NEW = 32
SERVE_BATCH = 8
SERVE_PAGE = 16
SERVE_PAGES = 1024
SERVE_MAX_LEN = SERVE_PROMPT[1] + SERVE_NEW + 2
SERVE_SLOTS = -(-SERVE_MAX_LEN // SERVE_PAGE) * SERVE_PAGE
# RWKV6-7B's layer count (32) and head count (64): prompts of these
# lengths broke the reference's cache padding (ROADMAP Queue 3, item 6)
RWKV_EXTRA_PROMPTS = (32, 64)
# the hybrid: one superblock of Jamba-1.5-Large is 45.1 B parameters,
# 90 GB in bf16, more than the card holds, so it serves at reduced();
# prompts of 1 token and of its H = 8 heads broke the reference's cache
# padding on Mamba state (ROADMAP Queue 3, item 7)
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_EXTRA_PROMPTS = (1, 8)
# the full-width Mamba path: the 7 Mamba sublayers of one Jamba
# superblock, prefills of (B, T) (a whole number of Jamba's 256-token
# chunks, and a ragged T over two batch rows), then decode steps from
# the second prefill's states; its CPU check runs one layer in fp32 over
# a prompt of MAMBA_CPU_PROMPT tokens and MAMBA_CPU_STEPS decode steps
MAMBA_PREFILLS = ((1, 4096), (2, 3001))
MAMBA_DECODE = 32
MAMBA_CPU_PROMPT = 256
MAMBA_CPU_STEPS = 4
# every plain kernel version a model path could call in place of its
# kernel; the model paths count their calls and fail on any
PLAIN_VERSIONS = ((kflash.kernel, "attention_plain"),
                  (kpaged.kernel, "paged_attention_plain"),
                  (kwkv.kernel, "wkv6_plain"),
                  (kssd.kernel, "ssd_plain"))
# the tag path: a chained table of 2^18 buckets at two tags a bucket,
# probed by one read wave
TAG_BUCKETS = 1 << 18
TAG_KEYS = 1 << 19
# the matrix path's workloads (``repro_torch.data.workloads``): YCSB's
# zipfian constant 0.99 on P-CLHT and P-ART, a skewed string-key scan
# mix sized so that ``replay`` (a sort of the live keys per scan) stays
# within some 20 s of host time, and a pinned hot set of 1% of the keys
# taking 90% of the draws.  The hot set runs F: its read-modify-write
# updates are what collide across streams (A's inserts are of fresh
# keys, so no two of its plans ever conflict and none defers)
MATRIX_ZIPF = dict(mix="F", n_load=1 << 18, n_run=1 << 16, dist="zipfian",
                   theta=0.99)
MATRIX_STRING = dict(mix="A", n_load=1 << 17, n_run=1 << 15,
                     dist="zipfian", theta=0.99, keyspace="string")
MATRIX_SCAN = dict(mix="E", n_load=1 << 14, n_run=4096, dist="zipfian",
                   theta=0.9, keyspace="string")
MATRIX_HOT = dict(mix="F", n_load=1 << 17, n_run=1 << 14, dist="hotset",
                  hot_frac=0.01, hot_op_frac=0.9)
HOT_PLAN = 256  # ops per client plan on the hot set
# RECIPE's five converted indexes, swept in both crash modes
CONVERTED = ("P-CLHT", "P-HOT", "P-BwTree", "P-ART", "P-Masstree")
# bf16 attention kernel against its plain version: the same fp32
# arithmetic in another order, each rounded once to bf16, so two outputs
# differ by up to 2 unit roundoffs (2^-8) of the value.  Each element is
# held to ATTN_STEPS unit roundoffs of its plain value, plus as many of
# 2^-8 of the output's largest magnitude for sums that cancel.  A
# dropped newest key moves hundreds of elements past that limit, and
# the check shows it does on the same inputs.
ATTN_STEPS = 4
# the card against the CPU, full width, bf16: 24 layers of Qwen2's
# products rounded to bf16 at different points by cuBLAS and the CPU's
# kernels; held to 5% of the largest logit
LOGIT_REL_TOL = 5e-2
# RWKV6-7B's 32 layers of random weights amplify bf16 rounding: on an
# H100 its bf16 logits differed from the CPU's bf16 run by 8.07% of the
# largest logit at a 32-token prompt, and they differ from an fp32 run of
# the same weights by a like amount (printed).  Its check runs the
# served weights upcast to fp32 (exactly) on both sides, fp32 products
# in full fp32 (no TF32): the same arithmetic in another order, held to
# 1e-3 of the largest logit.  The hybrid (8 layers with MoE routing, which
# a bf16 rounding can flip) and the full-width Mamba layer are checked the
# same way, within the same share of their largest output
FP32_LOGIT_REL_TOL = 1e-3


def kernel_name(mangled: str) -> str:
    """A CUDA kernel's name and template arguments from its mangled name
    (``decode_kernel<bf16,64>``), or the mangled name when it does not
    parse."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled[:60]
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    args = re.match(r"I(.*?)EEv", mangled[start + len(name):])
    if not args:
        return name
    words = re.findall(r"13__nv_bfloat16|Li(\d+)E|(f)", args.group(1))
    return name + "<" + ",".join(
        "bf16" if not n and not f else n or "float" for n, f in words) + ">"


def ptxas_lines(log: str) -> list:
    """Each kernel's registers, shared memory and spills from a build's
    ``-Xptxas -v`` output, one line a kernel."""
    out, name, info = [], None, []
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            if name:
                out.append(f"{name}: {'; '.join(info)}")
            name, info = kernel_name(m.group(1)), []
        elif name and ("registers" in line or "spill" in line):
            info.append(line.split(":", 1)[-1].strip()
                        if "registers" in line else line.strip())
    if name:
        out.append(f"{name}: {'; '.join(info)}")
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def counting_plain():
    """Count every call of a plain kernel version (``PLAIN_VERSIONS``)
    inside the block: yields the counts by name."""
    calls = {name: 0 for _, name in PLAIN_VERSIONS}
    real = {name: getattr(mod, name) for mod, name in PLAIN_VERSIONS}

    def counted(name):
        def wrapper(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return wrapper

    for mod, name in PLAIN_VERSIONS:
        setattr(mod, name, counted(name))
    try:
        yield calls
    finally:
        for mod, name in PLAIN_VERSIONS:
            setattr(mod, name, real[name])


def say(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0
    for by_width in kscan.WINDOWS.values():
        by_width.clear()


def read_counts() -> dict:
    """Launches by kernel, and the search's also by window width, as
    ``"scan_window C=1"``."""
    out = {name: n for counts in COUNTERS for name, n in counts.items()}
    for name, by_width in kscan.WINDOWS.items():
        for width, n in sorted(by_width.items()):
            out[f"{name} C={width}"] = n
    return out


def value_of(keys: np.ndarray) -> np.ndarray:
    """Vectorized ``core.ycsb.value_of``."""
    return (keys ^ 0x5DEECE66D) & ((1 << 62) - 1) | 1


def get_plan(keys: np.ndarray) -> Plan:
    n = keys.shape[0]
    return Plan.from_arrays(np.zeros(n, np.int32), keys, np.zeros(n, np.int64))


def op_keys(ops, kind=None) -> np.ndarray:
    return np.fromiter((k for o, k, _ in ops if kind in (None, o)), np.int64)


def read_back(session, keys: np.ndarray, what: str) -> None:
    """Every key must read back through plans with ``value_of(key)``.
    The first plan forces the kernel path, so a stale snapshot is
    re-exported once (an index whose rebuild floor scales with its size
    would otherwise answer these plans with scalar lookups)."""
    for lo in range(0, keys.shape[0], PLAN_OPS):
        chunk = keys[lo:lo + PLAN_OPS]
        res = session.execute(get_plan(chunk), force_kernel=lo == 0).results
        check(None not in res, f"{what}: a key did not read back")
        check(np.array_equal(np.asarray(res, np.int64), value_of(chunk)),
              f"{what}: a value differs from value_of(key)")


def timed_run(index, ops) -> tuple:
    ex = PhaseExecutor(index, batch_lookups=True, max_batch=PLAN_OPS)
    t0 = time.perf_counter()
    done = ex.run(ops)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def rate(n: int, secs: float) -> str:
    return f"{n} ops in {secs:.3f} s ({n / secs / 1e3:.3f} kops/s)"


def load_and_crash(session, n_load: int, seed: int, tag: str):
    """Load A, then a powerfail after which every key reads back."""
    load = generate("C", n_load, n_load, seed=seed)
    loaded = op_keys(load.load_ops)
    done, secs = timed_run(session.index, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    say(f"{tag} load: {rate(len(load.load_ops), secs)}")
    session.crash()
    t0 = time.perf_counter()
    read_back(session, loaded, f"{tag} after powerfail")
    say(f"{tag} crash: powerfail after the load; all {loaded.size} acked "
        f"keys read back in {time.perf_counter() - t0:.3f} s")
    return load, loaded


def ycsb_c(session, load, tag: str) -> None:
    done, secs = timed_run(session.index, load.run_ops)
    check(done["found"] == len(load.run_ops), f"{tag} YCSB-C: a lookup "
          "missed")
    say(f"{tag} YCSB-C: {rate(len(load.run_ops), secs)}, all found")
    read_back(session, op_keys(load.run_ops), f"{tag} YCSB-C")
    say(f"{tag} YCSB-C: every value equals value_of(key)")


def point_path(session, n_load: int, seed: int, tag: str, *,
               edge_keys: bool) -> None:
    """P-CLHT, P-ART, P-HOT: load, crash, C, A, C without fingerprints
    and a sample through the kernel path against scalar lookups."""
    index = session.index
    load, loaded = load_and_crash(session, n_load, seed, tag)
    ycsb_c(session, load, tag)

    mix_a = generate("A", n_load, max(n_load // 4, PLAN_OPS), seed=seed)
    done, secs = timed_run(index, mix_a.run_ops)
    check(done["acked"] == done["insert"], f"{tag} YCSB-A: an insert of a "
          "fresh key was not acknowledged")
    check(done["found"] == done["lookup"], f"{tag} YCSB-A: a lookup of a "
          "loaded key missed")
    say(f"{tag} YCSB-A: {rate(len(mix_a.run_ops), secs)}, {done['acked']} "
        f"acked of {done['insert']} inserts, {done['found']} found of "
        f"{done['lookup']} lookups")

    index.fingerprints = False
    c_off = op_keys(load.run_ops[:8 * PLAN_OPS])
    t0 = time.perf_counter()
    found = sum(session.execute(get_plan(c_off[lo:lo + PLAN_OPS]),
                                force_kernel=lo == 0).found
                for lo in range(0, c_off.size, PLAN_OPS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    index.fingerprints = True
    check(found == c_off.size, f"{tag} YCSB-C, fingerprints off: a lookup "
          "missed")
    say(f"{tag} YCSB-C, fingerprints off: {rate(c_off.size, secs)} (the "
        "first plan re-exports), all found")

    rng = np.random.default_rng(seed + 1)
    edge = np.array([0, HIGH, -1, loaded[0] | HIGH] if edge_keys else [],
                    np.int64)
    sample = np.concatenate([
        rng.choice(loaded, PLAN_OPS // 2),
        rng.choice(op_keys(mix_a.run_ops, "insert"), PLAN_OPS // 4),
        rng.integers(1, 1 << 62, size=PLAN_OPS // 4 - edge.size), edge])
    res = session.execute(get_plan(sample), force_kernel=True).results
    check(res == [index.lookup(int(k)) for k in sample],
          f"{tag} sampled keys: the kernel path differs from scalar lookup")
    say(f"{tag} sample: {sample.size} keys through the kernel path equal "
        "scalar lookup" + (" (key 0 and keys >= 2^63 included)"
                           if edge_keys else ""))


def scan_phase(session, ops, tag: str, *, check_all: bool) -> None:
    """Scan plans; with ``check_all`` every scan result must equal the
    scalar ``scan`` of the same (start, count)."""
    t0 = time.perf_counter()
    results = []
    for lo in range(0, len(ops), PLAN_OPS):
        res = session.execute(Plan.from_ops(ops[lo:lo + PLAN_OPS]))
        results.extend(res.results)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    scans = [(i, k, n) for i, (o, k, n) in enumerate(ops) if o == "scan"]
    scanned = sum(len(results[i]) for i, _, _ in scans)
    say(f"{tag}: {rate(len(ops), secs)}, {len(scans)} scans returned "
        f"{scanned} records")
    if check_all:
        index = session.index
        check(all(results[i] == index.scan(k, n) for i, k, n in scans),
              f"{tag}: a batched scan differs from the scalar scan")
        say(f"{tag}: every scan equals the scalar scan")


def sorted_path(session, n_load: int, seed: int, tag: str, *,
                n_e0: int, n_e: int) -> None:
    """P-Masstree, P-BwTree: load, crash, C, E0 and a short E."""
    load, _ = load_and_crash(session, n_load, seed, tag)
    ycsb_c(session, load, tag)
    before = kscan.LAUNCHES["scan_window"]
    scan_phase(session, generate("E0", n_load, n_e0, seed=seed).run_ops,
               f"{tag} YCSB-E0", check_all=True)
    check(kscan.LAUNCHES["scan_window"] > before, f"{tag} YCSB-E0: no scan "
          "wave ran the kernel")
    if n_e:
        before = kscan.LAUNCHES["scan_window"]
        scan_phase(session, generate("E", n_load, n_e, seed=seed).run_ops,
                   f"{tag} YCSB-E", check_all=False)
        say(f"{tag} YCSB-E: scan_window launches "
            f"{kscan.LAUNCHES['scan_window'] - before}")


# -- the scale-out path -----------------------------------------------------

def checked_results(res, want: np.ndarray, what: str) -> None:
    check(None not in res.results, f"{what}: a key did not read back")
    check(np.array_equal(np.asarray(res.results, np.int64), want),
          f"{what}: a value differs from the acknowledged one")


def c_columns(index, keys: np.ndarray, tag: str, route_ns=None,
              **kw) -> tuple:
    """YCSB-C plans of ``keys`` (every result must be ``value_of(key)``):
    (wall kops/s, modeled kops/s) over all plans but the first, which
    is forced onto the kernel path (a stale snapshot is re-exported)
    and not timed.  Modeled is ``critical_ns`` (routing + the slowest
    shard + merge) for a sharded index, the wall time otherwise.  A
    sharded index's ``route_ns`` of the timed plans is appended to the
    list ``route_ns`` when one is given."""
    wall = crit = n = 0
    for lo in range(0, keys.size, PLAN_OPS):
        chunk = keys[lo:lo + PLAN_OPS]
        t0 = time.perf_counter_ns()
        res = index.execute(get_plan(chunk), force_kernel=lo == 0, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter_ns() - t0
        checked_results(res, value_of(chunk), f"{tag} YCSB-C")
        if lo:
            wall += dt
            crit += getattr(res, "critical_ns", dt)
            n += chunk.size
            if route_ns is not None:
                route_ns.append(res.route_ns)
    check(n > 0, f"{tag} YCSB-C: fewer than two plans to time")
    return n / wall * 1e6, n / crit * 1e6


def report_columns(tag: str, one: tuple, many: tuple, shards: int) -> None:
    say(f"{tag} YCSB-C, reporting model: 1 shard wall {one[0]:.3f} / "
        f"modeled {one[1]:.3f} kops/s; {shards} shards wall "
        f"{many[0]:.3f} / modeled {many[1]:.3f} kops/s; {shards}-shard / "
        f"1-shard wall {many[0] / one[0]:.3f}x, modeled "
        f"{many[1] / one[1]:.3f}x")


def ycsb_a(index, n_load: int, seed: int, tag: str) -> np.ndarray:
    """YCSB-A (a quarter of the load); returns the inserted keys."""
    mix_a = generate("A", n_load, max(n_load // 4, PLAN_OPS), seed=seed)
    done, secs = timed_run(index, mix_a.run_ops)
    check(done["acked"] == done["insert"], f"{tag} YCSB-A: an insert of a "
          "fresh key was not acknowledged")
    check(done["found"] == done["lookup"], f"{tag} YCSB-A: a lookup of a "
          "loaded key missed")
    say(f"{tag} YCSB-A: {rate(len(mix_a.run_ops), secs)}, {done['acked']} "
        f"acked of {done['insert']} inserts, {done['found']} found of "
        f"{done['lookup']} lookups")
    return op_keys(mix_a.run_ops, "insert")


def shard_crash(session, loaded: np.ndarray, inserted: np.ndarray,
                rng, tag: str) -> dict:
    """A crash inside one shard's group commit during a cross-shard
    update plan: the siblings finish and serve the new values with no
    replay; the shard is power-failed, its sub-plan replayed, and then
    every acknowledged key reads back.  Returns the updated values."""
    idx = session.index
    keys = rng.choice(loaded, PLAN_OPS, replace=False)
    new = value_of(keys) ^ 2
    routes = kpart.route_ref(keys, idx.n_shards, idx.scheme)
    victim = int(routes[0])
    mine = routes == victim
    idx.pmems[victim].arm_crash(after_stores=int(mine.sum()) // 2)
    try:
        session.execute(Plan.from_arrays(np.full(keys.size, 2, np.int32),
                                         keys, new))
        crashed = False
    except CrashPoint:
        crashed = True
    check(crashed and idx.last_crashed_shard == victim,
          f"{tag} crash: the armed shard did not crash")
    check(all(pm.crashes == 0 for s, pm in enumerate(idx.pmems)
              if s != victim), f"{tag} crash: a sibling shard crashed")
    sib = idx.execute(get_plan(keys[~mine]), mesh=False)
    checked_results(sib, new[~mine], f"{tag} crash: a sibling shard")
    check(idx.stats["replayed_ops"] == 0, f"{tag} crash: a replay ran "
          "before recovery")
    t0 = time.perf_counter()
    idx.crash_shard(victim)
    replayed = idx.recover_shard(victim, replay=True)
    check(replayed == int(mine.sum()), f"{tag} crash: the replay ran "
          f"{replayed} ops, not the shard's {int(mine.sum())}")
    acked = np.concatenate([loaded, inserted])
    want = value_of(acked)
    order = np.argsort(loaded)
    want[order[np.searchsorted(loaded, keys, sorter=order)]] = new
    for lo in range(0, acked.size, PLAN_OPS):
        res = idx.execute(get_plan(acked[lo:lo + PLAN_OPS]),
                          force_kernel=lo == 0, mesh=False)
        checked_results(res, want[lo:lo + PLAN_OPS],
                        f"{tag} crash: after the replay")
    say(f"{tag} crash: shard {victim} crashed inside its group commit; "
        f"{int((~mine).sum())} sibling ops served their new values with "
        f"no replay; {replayed} ops replayed; all {acked.size} acked keys "
        f"read back in {time.perf_counter() - t0:.3f} s")
    return dict(zip(keys.tolist(), new.tolist()))


def stream_phase(session, loaded: np.ndarray, updated: dict, rng,
                 tag: str) -> dict:
    """4 client streams of YCSB-A plans (lookups of loaded keys, inserts
    of fresh keys above 2^61) over one shared op list, neighbouring
    plans overlapping by half, so duplicate inserts conflict and some
    plans defer.  Every ticket's results must equal a sequential oracle
    applied in tick order (plans admitted in one tick are conflict-free,
    so their order within it does not matter).  Returns the admission
    checks' inputs, the largest reference set last."""
    n_ops = (STREAMS * STREAM_PLANS + 1) * PLAN_OPS // 2
    is_get = rng.random(n_ops) < 0.5
    keys = np.where(is_get, rng.choice(loaded, n_ops),
                    rng.integers(1 << 61, 1 << 62, size=n_ops))
    ops = [("lookup", int(k), 0) if g else ("insert", int(k),
                                            int(value_of(k)))
           for g, k in zip(is_get, keys)]
    hist = Histogram("streams")
    drv = session.streams(STREAMS, lat_hist=hist)
    tickets = []
    for i in range(STREAMS * STREAM_PLANS):
        lo = i * PLAN_OPS // 2
        tickets.append(drv.streams[i % STREAMS].submit(
            Plan.from_ops(ops[lo:lo + PLAN_OPS])))
    checks = []
    real = dstreams.conflict_any

    def recorded(kinds_a, keys_a, kinds_b, keys_b, **kw):
        checks.append((kinds_a, keys_a, kinds_b, keys_b))
        return real(kinds_a, keys_a, kinds_b, keys_b, **kw)

    dstreams.conflict_any = recorded
    t0 = time.perf_counter()
    try:
        ticks = drv.run()
    finally:
        dstreams.conflict_any = real
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not drv.pending(), f"{tag} streams: a plan was never admitted")
    check(drv.stats["deferred_plans"] > 0, f"{tag} streams: no plan "
          "deferred")
    inserted = set()
    for t in sorted(tickets, key=lambda t: t.tick):
        want = []
        for kind, k, _ in plan_ops(t.plan):
            if kind == "lookup":
                want.append(value_of(k) if k in inserted
                            else updated.get(k, int(value_of(k))))
            else:
                want.append(k not in inserted)
                inserted.add(k)
        check(t.result == want, f"{tag} streams: a ticket's results "
              "differ from the sequential oracle")
    p50, p99 = (hist.percentile(q) / 1e3 for q in (50, 99))
    say(f"{tag} streams: {STREAMS} streams, {len(tickets)} plans of "
        f"{PLAN_OPS} YCSB-A ops in {ticks} ticks, {secs:.3f} s "
        f"({len(tickets) * PLAN_OPS / secs / 1e3:.3f} kops/s wall); "
        f"deferred_plans {drv.stats['deferred_plans']}, multi-stream "
        f"ticks {drv.stats['multi_stream_ticks']}; tick-amortized "
        f"latency p50 {p50:.3f} us, p99 {p99:.3f} us per op; "
        f"{len(checks)} admission checks, reference sets of "
        f"{min(c[2].size for c in checks)}-"
        f"{max(c[2].size for c in checks)} ops; every ticket equals the "
        "sequential oracle")
    checks.sort(key=lambda c: c[2].size)
    return checks


def plan_ops(plan):
    names = {0: "lookup", 1: "insert", 2: "update", 3: "delete", 4: "scan"}
    kinds, keys, aux = plan.arrays()
    return [(names[int(o)], int(k), int(a))
            for o, k, a in zip(kinds, keys, aux)]


def clht_scale_out(sessions, n_load: int, seed: int) -> dict:
    tag = f"P-CLHT x{SHARDS}"
    session = open_index("clht", shards=SHARDS, mesh_reads=True)
    idx = session.index
    check(session.device.type == "cuda" and all(
        sh.device.type == "cuda" for sh in idx.shards),
        f"{tag}: the shards are not on the card")
    load = generate("C", n_load, n_load, seed=seed)
    loaded = op_keys(load.load_ops)
    done, secs = timed_run(idx, load.load_ops)
    check(done["acked"] == loaded.size, f"{tag} Load A: an insert was not "
          "acknowledged")
    say(f"{tag} load: {rate(loaded.size, secs)}")
    c_keys = op_keys(load.run_ops[:(C_PLANS + 1) * PLAN_OPS])
    before = idx.stats["mesh_plans"]
    partitions = kpart.LAUNCHES["shard_partition"]
    t0 = time.perf_counter()
    mesh_route, shard_route = [], []
    mesh = c_columns(idx, c_keys, f"{tag} mesh", mesh_route, mesh=True)
    n_plans = -(-c_keys.size // PLAN_OPS)
    check(idx.stats["mesh_plans"] - before == n_plans,
          f"{tag}: a YCSB-C plan did not take the mesh path")
    check(kpart.LAUNCHES["shard_partition"] - partitions == n_plans,
          f"{tag}: a YCSB-C plan did not launch shard_partition once")
    say(f"{tag} YCSB-C, mesh path: wall {mesh[0]:.3f} kops/s, modeled "
        f"{mesh[1]:.3f} kops/s, all found ({n_plans} plans, the "
        f"first re-exporting every shard's run; "
        f"{time.perf_counter() - t0:.3f} s)")
    per_shard = c_columns(idx, c_keys, f"{tag} per-shard", shard_route,
                          mesh=False)
    say(f"{tag} YCSB-C route_ns, mean of {len(mesh_route)} plans: mesh "
        f"path {np.mean(mesh_route):.1f} ns, per-shard path "
        f"{np.mean(shard_route):.1f} ns")
    one = c_columns(sessions["P-CLHT"].index, c_keys, "P-CLHT")
    report_columns("P-CLHT", one, per_shard, SHARDS)
    inserted = ycsb_a(idx, n_load, seed, tag)
    rng = np.random.default_rng(seed + 7)
    updated = shard_crash(session, loaded, inserted, rng, tag)
    checks = stream_phase(session, loaded, updated, rng, tag)
    return {"session": session, "c_keys": c_keys, "checks": checks}


def cceh_columns(n_load: int, seed: int) -> None:
    cols = {}
    for shards in (1, SHARDS):
        tag = "CCEH" if shards == 1 else f"CCEH x{shards}"
        session = open_index("cceh", shards=shards)
        load = generate("C", n_load, n_load, seed=seed)
        done, secs = timed_run(session.index, load.load_ops)
        check(done["acked"] == len(load.load_ops), f"{tag} Load A: an "
              "insert was not acknowledged")
        say(f"{tag} load: {rate(len(load.load_ops), secs)}")
        kw = {"mesh": False} if shards > 1 else {}
        cols[shards] = c_columns(session.index, op_keys(
            load.run_ops[:(C_PLANS + 1) * PLAN_OPS]), tag, **kw)
        say(f"{tag} YCSB-C: wall {cols[shards][0]:.3f} kops/s, modeled "
            f"{cols[shards][1]:.3f} kops/s, all found")
        ycsb_a(session.index, n_load, seed, tag)
    report_columns("CCEH", cols[1], cols[SHARDS], SHARDS)


def fastfair_scans(n_load: int, seed: int) -> None:
    tag = "FAST&FAIR x4"
    session = open_index("fastfair", shards=4, scheme="prefix@59")
    idx = session.index
    load = generate("E0", n_load, 2 * PLAN_OPS, seed=seed)
    done, secs = timed_run(idx, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    loaded = op_keys(load.load_ops)
    per_shard = np.bincount(kpart.route_ref(loaded, 4, idx.scheme),
                            minlength=4)
    check((per_shard > 0).all(), f"{tag}: a shard holds no key")
    say(f"{tag} load: {rate(loaded.size, secs)}; keys per shard "
        f"{per_shard.tolist()}")
    read_back(session, loaded[:PLAN_OPS], f"{tag} YCSB-C")
    merges, launched = idx.stats["scan_merges"], kscan.LAUNCHES["scan_window"]
    ops = load.run_ops
    t0 = time.perf_counter()
    results = []
    for lo in range(0, len(ops), PLAN_OPS):
        results.extend(session.execute(Plan.from_ops(
            ops[lo:lo + PLAN_OPS])).results)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(idx.stats["scan_merges"] - merges == len(ops), f"{tag} YCSB-E0: "
          "a scan was not merged across shards")
    check(kscan.LAUNCHES["scan_window"] > launched, f"{tag} YCSB-E0: no "
          "scan wave ran the kernel")
    # the scalar walk of every shard's leaves, merged
    items = sorted(kv for sh in idx.shards for kv in sh.items())
    starts = np.fromiter((k for k, _ in items), np.int64, len(items))
    for (_, k, n), got in zip(ops, results):
        lo = int(np.searchsorted(starts, k))
        check(got == items[lo:lo + n], f"{tag} YCSB-E0: a merged scan "
              "differs from the shards' scalar items")
    say(f"{tag} YCSB-E0: {rate(len(ops), secs)}, {len(ops)} scans merged "
        "across shards, each equal to the scalar walk of every shard's "
        "items")


def level_reads(n_load: int, seed: int) -> None:
    tag = "Level hashing"
    session = open_index("level")
    load = generate("C", n_load, n_load, seed=seed)
    done, secs = timed_run(session.index, load.load_ops)
    check(done["acked"] == len(load.load_ops), f"{tag} Load A: an insert "
          "was not acknowledged")
    say(f"{tag} load: {rate(len(load.load_ops), secs)}")
    wall, _ = c_columns(session.index, op_keys(load.run_ops), tag)
    say(f"{tag} YCSB-C: {wall:.3f} kops/s (the first plan re-exports), "
        "every value equals value_of(key)")


def scale_out_path(sessions, args) -> dict:
    out = clht_scale_out(sessions, args.n_clht, args.seed)
    cceh_columns(args.n_cceh, args.seed)
    fastfair_scans(args.n_fastfair, args.seed)
    level_reads(args.n_level, args.seed)
    return out


# -- kernels against their plain versions ---------------------------------

def time_calls(fn, batches, reps: int):
    """(device ms, call ms) per call, cycling through ``batches`` so
    most rows the batches touch are not in L2 (the main path's plans
    probe different keys each time).  Call ms: CUDA events around
    ``reps`` back-to-back calls, host launch cost included.  Device ms:
    for each CUDA kernel the profiler records over ``reps`` calls, its
    mean duration times its launches a call, summed; or None when it
    records none.  (The profiler may miss a window's first launches: 50
    of 64 were recorded in one H100 run, so the recorded total over
    ``reps`` would read low.)"""
    for b in batches[-4:]:
        fn(*b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*batches[i % len(batches)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            fn(*batches[i % len(batches)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total / e.count * max(1, round(e.count / reps))
                 for e in kernels if e.count)
    names = sorted(kernels, key=lambda e: -e.device_time_total)[:3]
    say("  profiler: " + ("; ".join(
        f"{e.key[:60]} x{e.count} {e.device_time_total:.1f} us"
        for e in names) or "no device kernels recorded"))
    return (dev_us / 1e3 if dev_us > 0 else None), call_ms


def bound(n_bytes: float, ops: float):
    """Least time in ms: bytes over HBM bandwidth against lane
    operations over the lane rate, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, plain) -> int:
    """Bit-identical or fail; the max abs error (0) over all outputs."""
    err = 0
    for g, p in zip(got, plain):
        if p is None:
            continue
        check(torch.equal(g, p), f"{name}: kernel differs from its plain "
              "version")
        err = max(err, int((g.to(torch.int64) - p.to(torch.int64))
                           .abs().max()))
    return err


def row(name: str, launches: dict, err: int, timed: dict, bms: float,
        by: str, library_ms, shape: str) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": float(err), "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": shape}


def time_kernel(name: str, fn, plain_fn, batches, reps: int = 640,
                plain_reps: int = 32) -> dict:
    """The kernel's and the plain version's time per call: the card's
    time where the profiler saw the kernels, else the event time per
    call (which then includes the host's launch cost)."""
    dev_ms, call_ms = time_calls(fn, batches, reps)
    plain_dev, plain_call = time_calls(plain_fn, batches, plain_reps)
    say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms per launch; "
        f"plain: device {plain_dev} ms, call {plain_call:.6f} ms")
    return {"ms": dev_ms if dev_ms is not None else call_ms,
            "plain_ms": plain_dev if plain_dev is not None else plain_call}


def probe_table(index):
    """The table the P-CLHT path's last read wave probed: (the line
    table on the card, the longest chain, the bucket count), and the
    host export it was packed from."""
    snap = index.snapshot()
    check("clht_probe" in snap.cache, "the P-CLHT path left no table on "
          "the card")
    return snap.cache["clht_probe"], snap.arrays


def probe_queries(arrays, depth: int, n: int, rng) -> np.ndarray:
    """Hits, misses, fingerprint near-misses (a fresh key whose
    fingerprint equals a slot's in its own chain), values of 2^32 and
    above, and key 0."""
    keys, _, nxt, n_buckets, fps = arrays
    resident = keys[keys != 0]
    hits = rng.choice(resident, n // 2)
    misses = rng.integers(1, 1 << 62, size=n // 4)
    pool = rng.integers(1, 1 << 62, size=1 << 21)
    pool = pool[~np.isin(pool, resident)]
    row_ = (mix64(pool) % np.uint64(n_buckets)).astype(np.int64)
    pfp = fp64(pool)
    near = np.zeros(pool.size, bool)
    for _ in range(depth):
        live = row_ >= 0
        safe = np.where(live, row_, 0)
        near |= live & (fps[safe] == pfp[:, None]).any(axis=1)
        row_ = np.where(live, nxt[safe], -1)
    n_near = n - hits.size - misses.size - 4
    check(int(near.sum()) >= n_near, "too few fingerprint near-misses")
    q = np.concatenate([hits, misses, pool[near][:n_near],
                        np.zeros(4, np.int64)])
    rng.shuffle(q)
    return q


def probe_bound(arrays, depth: int, q: np.ndarray, use_fp: bool):
    """Least time for one probe launch: the bytes this batch's data
    needs (each input byte read once, each output written once) over
    HBM bandwidth, against its lane operations over the lane rate."""
    keys, vals, nxt, n_buckets, fps = arrays
    row_ = (mix64(q) % np.uint64(n_buckets)).astype(np.int64)
    qfp = fp64(q)
    rows, cand, found = set(), set(), set()
    n_cand = 0
    got = np.zeros(q.size, bool)
    for _ in range(depth):
        live = row_ >= 0
        safe = np.where(live, row_, 0)
        rows.update(row_[live].tolist())
        match = fps[safe] == qfp[:, None] if use_fp else np.ones(
            (q.size, SLOTS), bool)
        match &= live[:, None]
        hit = match & (keys[safe] == q[:, None])
        for i, s in zip(*np.nonzero(match)):
            cand.add((int(safe[i]), int(s)))
        first = hit & ~got[:, None]
        first &= np.cumsum(first, axis=1) == 1
        for i, s in zip(*np.nonzero(first)):
            found.add((int(safe[i]), int(s)))
        got |= hit.any(axis=1)
        n_cand += int(match.sum())
        row_ = np.where(live, nxt[safe], -1)
    per_row = (SLOTS + 8) if use_fp else (SLOTS * 8 + 8)
    n_bytes = (q.size * 16 + len(rows) * per_row
               + (len(cand) * 8 if use_fp else 0) + len(found) * 8
               + q.size * (1 + 8 + (8 if use_fp else 0)))
    lanes = q.size * depth * SLOTS
    return bound(n_bytes, q.size * 30 + lanes + 2 * n_cand)


def probe_vs_plain(index, seed: int, launches: dict) -> list:
    (lines, depth, n), arrays = probe_table(index)
    dev = lines.device
    n_rows = arrays[0].shape[0]
    say(f"P-CLHT table: {n_rows} rows, {n} buckets, longest chain "
        f"{depth}, {lines.shape[0]} lines ({lines.shape[0] - n_rows} chain "
        f"copies), {lines.numel() * lines.element_size()} bytes on {dev}")
    rng = np.random.default_rng(seed + 2)
    q = probe_queries(arrays, depth, Q, rng)

    def on_card(qs):
        b = (mix64(qs) % np.uint64(n)).astype(np.int64)
        return torch.from_numpy(qs).to(dev), torch.from_numpy(b).to(dev)

    qt, bt = on_card(q)
    resident = arrays[0][arrays[0] != 0]
    timing = [on_card(np.concatenate([rng.choice(resident, Q // 2),
                                      rng.integers(1, 1 << 62, Q // 2)]))
              for _ in range(64)]
    rows = []
    for name, use_fp in (("probe64_fp", True), ("probe64", False)):
        got = kprobe.probe_chain(qt, bt, lines, depth, use_fp=use_fp)
        torch.cuda.synchronize()
        plain = kprobe.probe_chain_plain(qt, bt, lines, depth, use_fp=use_fp)
        err = compare(name, got, plain)
        found = got[0].cpu().numpy()
        check(found.sum() >= Q // 2, f"{name}: drawn hits were not found")
        check((got[1].cpu().numpy()[found] >= 1 << 32).any(),
              f"{name}: no value of 2^32 or above")
        if use_fp:
            check(int(got[3].sum()) > 0, "probe64_fp: no fingerprint "
                  "false positive reached the full compare")
        say(f"{name}: bit-identical to its plain version on {Q} queries "
            f"({int(found.sum())} found)")
        timed = time_kernel(name, lambda a, b: kprobe.probe_chain(
            a, b, lines, depth, use_fp=use_fp),
            lambda a, b: kprobe.probe_chain_plain(
                a, b, lines, depth, use_fp=use_fp), timing)
        bms, by = probe_bound(arrays, depth, q, use_fp)
        say(f"{name}: bound {bms:.9f} ms ({by}) at Q={Q}, depth {depth}; "
            f"main-path launches {launches[name]}")
        rows.append(row(name, launches, err, timed, bms, by, None,
                        f"P-CLHT, Q={Q}, depth {depth}"))
    return rows


def radix_queries(arrays, n: int, rng) -> np.ndarray:
    """Hits, misses, partial-key near-misses (a leaf's key with bit 8
    flipped: the walk, which stops at the leaf's shallow level, reaches
    the same leaf, whose low byte matches and whose key does not), key
    0 and keys of 2^63 and above."""
    leaves = arrays["leaf_key"][np.asarray(arrays["is_leaf"]) != 0]
    hits = rng.choice(leaves, n // 2)
    near = rng.choice(leaves, n // 4) ^ 0x100
    edge = np.array([0, HIGH, -1, leaves[0] | HIGH], np.int64)
    misses = rng.integers(1, 1 << 62, size=n - hits.size - near.size - 4)
    q = np.concatenate([hits, near, misses, edge]).astype(np.int64)
    rng.shuffle(q)
    return q


def radix_bound(arrays, q: np.ndarray):
    """Least time for one descent launch over this batch: the one packed
    child entry taken at each visited inner row (it carries the child's
    level and leaf bit), each reached leaf's fingerprint byte, the key
    and value words of the leaves whose fingerprint matched, the
    queries, and the outputs (found, value, three counts)."""
    children, level = arrays["children"], arrays["level"]
    is_leaf = np.asarray(arrays["is_leaf"]) != 0
    lfp = np.asarray(arrays["leaf_fp"])
    unit_bits = int(arrays.get("unit_bits", 8))
    n_units, fan = 64 // unit_bits, 1 << unit_bits
    uq = q.astype(np.uint64)
    qfp = fp_partial(q)
    node = np.zeros(q.size, np.int64)
    active = np.ones(q.size, bool)
    entries, leaves, matched = [], [], []
    steps = 0
    for _ in range(n_units + 1):
        idx = np.nonzero(active)[0]
        steps += idx.size
        at = node[idx]
        leaf = is_leaf[at]
        leaves.append(at[leaf])
        matched.append(at[leaf & (lfp[at] == qfp[idx])])
        active[idx[leaf]] = False
        idx, at = idx[~leaf], at[~leaf]
        lvl = np.clip(level[at], 0, n_units - 1).astype(np.uint64)
        shift = np.uint64(unit_bits) * (np.uint64(n_units - 1) - lvl)
        unit = ((uq[idx] >> shift) & np.uint64(fan - 1)).astype(np.int64)
        entries.append(at * fan + unit)
        child = children[at, unit].astype(np.int64)
        stop = child < 0
        active[idx[stop]] = False
        node[idx[~stop]] = child[~stop]
    uniq = [np.unique(np.concatenate(a)).size
            for a in (entries, leaves, matched)]
    n_bytes = (q.size * 8 + uniq[0] * 4 + uniq[1] + uniq[2] * 16
               + q.size * (1 + 8 + 12))
    return bound(n_bytes, steps * 12 + q.size * 10)


def time_in_place(fn, fresh, reps: int) -> float:
    """ms a call of ``fn``, which rewrites its input in place: each call
    is given a fresh copy (``fresh()``, untimed), and CUDA events around
    the call alone time it."""
    total = 0.0
    for i in range(reps + 1):  # the first call warms up
        args = fresh()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if i:
            total += start.elapsed_time(end)
    return total / reps


def pack_vs_plain(tag: str, arrays, pages, unit_bits: int) -> tuple:
    """The per-epoch packing at the main path's size: the export's child
    table uploaded afresh and packed by the kernel and by its plain
    version, each held to the other and to the table the path's read
    waves descended; then both timed.  Returns (err, timed, bound ms,
    bound by, entries)."""
    table, hdr, root = art_ops.upload_children(
        arrays["children"], arrays["level"], arrays["is_leaf"],
        unit_bits=unit_bits, device=pages[0].device)
    check(root == pages[1], f"art_pack_entries ({tag}): the root header "
          "differs from the main path's")
    raw, plain = table.clone(), table.clone()
    kart.kernel.pack_entries(table, hdr)
    torch.cuda.synchronize()
    kart.ref.pack_entries_plain(plain, hdr)
    err = compare(f"art_pack_entries ({tag})", (table,), (plain,))
    check(torch.equal(table, pages[0]), f"art_pack_entries ({tag}): the "
          "packed table differs from the one the main path descended")
    n_entries = table.numel()
    say(f"art_pack_entries ({tag}): bit-identical to its plain version "
        f"and to the main path's table on {n_entries} entries "
        f"({int((table >= 0).sum())} children)")

    def fresh():
        table.copy_(raw)
        return table, hdr
    timed = {"ms": time_in_place(kart.kernel.pack_entries, fresh, 5),
             "plain_ms": time_in_place(kart.ref.pack_entries_plain, fresh,
                                       3)}
    say(f"art_pack_entries ({tag}): {timed['ms']:.6f} ms a call, plain "
        f"{timed['plain_ms']:.6f} ms (CUDA events around the call)")
    # each entry read and written once, each row's header read once;
    # three lane operations an entry (range test, shift, or)
    bms, by = bound(n_entries * 8 + hdr.numel() * 4, n_entries * 3)
    del table, raw, plain, hdr
    return err, timed, bms, by, n_entries


def radix_vs_plain(sessions, seed: int, launches: dict) -> list:
    """art_descend at 8-bit (P-ART) and 4-bit (P-HOT) units, and the
    per-epoch packing of their child entries; the rows carry the P-ART
    numbers, the main path's shape."""
    rows, packs = [], []
    err = 0
    for tag, session in sessions:
        snap = session.index.snapshot()
        check("art_probe" in snap.cache, f"the {tag} path left no node "
              "pages on the card")
        unit_bits, *pages = snap.cache["art_probe"]
        n_bytes = sum(t.numel() * t.element_size() for t in pages
                      if isinstance(t, torch.Tensor))
        say(f"{tag} node pages: {pages[0].shape[0]} rows, {unit_bits}-bit "
            f"units, root header {pages[1]}, {n_bytes} bytes on "
            f"{pages[0].device}")
        rng = np.random.default_rng(seed + 3)
        q = radix_queries(snap.arrays, Q, rng)
        qt = torch.from_numpy(q).to(pages[0].device)
        got = kart.art_descend(qt, *pages, unit_bits=unit_bits)
        torch.cuda.synchronize()
        plain = kart.descend_plain(qt, *pages, unit_bits=unit_bits)
        err = max(err, compare(f"art_descend ({tag})", got, plain))
        found = int(got[0].sum())
        check(found >= Q // 2 - 64, f"art_descend ({tag}): drawn hits were "
              "not found")
        check(int(got[4].sum()) > 0, f"art_descend ({tag}): no fingerprint "
              "false positive reached the full compare")
        say(f"art_descend ({tag}): bit-identical to its plain version on "
            f"{Q} queries ({found} found)")
        leaves = snap.arrays["leaf_key"][
            np.asarray(snap.arrays["is_leaf"]) != 0]
        timing = [(torch.from_numpy(np.concatenate([
            rng.choice(leaves, Q // 2),
            rng.integers(1, 1 << 62, Q // 2)])).to(qt.device),)
            for _ in range(64)]
        timed = time_kernel(
            f"art_descend ({tag})",
            lambda a: kart.art_descend(a, *pages, unit_bits=unit_bits),
            lambda a: kart.descend_plain(a, *pages, unit_bits=unit_bits),
            timing)
        bms, by = radix_bound(snap.arrays, q)
        say(f"art_descend ({tag}): bound {bms:.9f} ms ({by}) at Q={Q}")
        rows.append((tag, timed, bms, by, unit_bits, pages[0].shape[0]))
        packs.append((tag,) + pack_vs_plain(tag, snap.arrays, pages,
                                            unit_bits))
    tag, timed, bms, by, unit_bits, n_rows = rows[0]
    say(f"art_descend: main-path launches {launches['art_descend']}")
    say(f"art_pack_entries: main-path launches "
        f"{launches['art_pack_entries']}")
    p_tag, p_err, p_timed, p_bms, p_by, n_entries = packs[0]
    return [row("art_descend", launches, err, timed, bms, by, None,
                f"{tag}, Q={Q}, {unit_bits}-bit units, {n_rows} rows"),
            row("art_pack_entries", launches,
                max(p[1] for p in packs), p_timed, p_bms, p_by, None,
                f"{p_tag}, {n_entries} entries, {n_rows} rows")]


def scan_bound(keys: np.ndarray, q: np.ndarray, counts: np.ndarray,
               width: int, base=None, length=None):
    """Least time for one search launch over this batch: the keys a
    binary search visits (fewer than the kernel's 33-way rounds read, so
    the bound is the function's, not the design's), the window entries
    that are valid (key and value), the queries and counts (and with a
    shard axis each row's base and length), and the [Q, C] outputs."""
    n = keys.size
    rows = base is not None
    lo = base.copy() if rows else np.zeros(q.size, np.int64)
    hi = base + length if rows else np.full(q.size, n, np.int64)
    end = hi.copy()
    visited = []
    steps = 0
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) // 2
        visited.append(mid[act])
        steps += int(act.sum())
        less = keys[np.minimum(mid, n - 1)] < q
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    off = np.arange(width)
    pos = lo[:, None] + off
    ok = (off < counts[:, None]) & (pos < end[:, None])
    n_window = np.unique(pos[ok]).size
    n_bytes = (q.size * (28 if rows else 12)
               + np.unique(np.concatenate(visited)).size * 8
               + n_window * 16 + q.size * width * 17)
    return bound(n_bytes, steps * 6 + q.size * width * 3)


def search_rounds(tag: str, keys: np.ndarray, q: np.ndarray, base=None,
                  length=None) -> None:
    """Print the dependent rounds the kernel's 33-way search makes on
    this batch (``ref.ways_lower_bound``, checked against
    ``np.searchsorted``), beside a binary search's."""
    lb, rounds = kscan.ref.ways_lower_bound(keys, q, base, length)
    if base is None:
        check(np.array_equal(lb, np.searchsorted(keys, q)), f"{tag}: the "
              "search model is not the lower bound")
    n = int(keys.size if length is None else np.max(length))
    most = next(r for r in range(64) if 33 ** r >= n + 1)
    check(int(rounds.max()) <= most + 1, f"{tag}: a query made more than "
          f"ceil(log33(n + 1)) + 1 = {most + 1} search rounds")
    say(f"{tag}: search rounds a query: max {int(rounds.max())}, mean "
        f"{rounds.mean():.4f} (ceil(log33(n + 1)) = {most}, a binary "
        f"search ceil(log2(n + 1)) = {n.bit_length()}; n = {n})")


def scan_edges(dev) -> int:
    """scan_window against its plain version on runs of 0, 1, 31, 32,
    33, 34, 1089 and 1090 entries (where the rounds change), windows of
    1, 2, 33 and 128, negative keys, starts below and above the run, key
    0, -1 and keys of 2^63 and above, counts of 0."""
    rng = np.random.default_rng(7)
    err = 0
    runs, starts = [], []
    for n in (0, 1, 31, 32, 33, 34, 1089, 1090):
        keys = np.unique(rng.integers(-(1 << 62), 1 << 62, size=n + 16))
        keys = np.sort(rng.choice(keys, n, replace=False)).astype(np.int64)
        vals = rng.integers(1, 1 << 62, size=n)
        q = rng.integers(HIGH, (1 << 63) - 1, size=1024)
        if n:
            q[:500] = rng.choice(keys, 500)
            q[500:504] = [keys[0] - 1, keys[0], keys[-1], keys[-1] + 1]
        q[-5:] = [0, -1, HIGH, HIGH + 1, (1 << 63) - 1]
        runs.append((keys, vals))
        starts.append(q)
        for width in (1, 2, 33, 128):
            counts = rng.integers(0, width + 1, size=q.size).astype(np.int32)
            counts[::9] = 0
            t = [torch.from_numpy(a).to(dev) for a in (q, counts, keys,
                                                        vals)]
            got = kscan.scan_window(*t, max_count=width)
            torch.cuda.synchronize()
            err = max(err, compare(f"scan_window (n={n}, C={width})", got,
                                   kscan.scan_window_plain(
                                       *t, max_count=width)))
    # the same runs stacked, each query row on its own run
    sizes = np.array([k.size for k, _ in runs])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    shard = np.repeat(np.arange(len(runs)), [q.size for q in starts])
    for width in (1, 128):
        counts = rng.integers(0, width + 1, size=shard.size).astype(np.int32)
        counts[::9] = 0
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            np.concatenate(starts), counts, offsets[:-1][shard],
            sizes[shard], np.concatenate([k for k, _ in runs]),
            np.concatenate([v for _, v in runs]))]
        got = kscan.scan_window_rows(*t, max_count=width)
        torch.cuda.synchronize()
        err = max(err, compare(f"scan_window_sharded (edge runs, C={width})",
                               got, kscan.scan_window_rows_plain(
                                   *t, max_count=width)))
    say("scan_window: bit-identical to its plain version on runs of 0, 1, "
        "31, 32, 33, 34, 1089 and 1090 entries at C = 1, 2, 33 and 128, and "
        "scan_window_sharded on the same runs stacked at C = 1 and 128")
    return err


def scan_vs_plain(session, seed: int, launches: dict) -> list:
    """scan_window at windows of 1 (lookups) and 128 (YCSB-E scans) on
    the P-Masstree run, and on short runs at the search's edges; the row
    carries the scan numbers, a line the lookups', and
    ``torch.searchsorted`` is timed as the library call for the lower
    bound."""
    snap = session.index.snapshot()
    keys_np = np.asarray(snap.arrays["keys"], np.int64)
    vals_np = np.asarray(snap.arrays["vals"], np.int64)
    dev = session.device
    keys, vals = kscan.prepare_sorted(keys_np, vals_np, device=dev)
    say(f"P-Masstree run: {keys_np.size} entries, "
        f"{2 * keys.numel() * keys.element_size()} bytes on {dev}")
    rng = np.random.default_rng(seed + 4)
    q = np.concatenate([rng.choice(keys_np, Q // 2),
                        rng.choice(keys_np, Q // 4) + 1,
                        rng.integers(1, 1 << 62, size=Q // 4 - 4),
                        [0, HIGH, -1, keys_np[-1] + 1]]).astype(np.int64)
    rng.shuffle(q)
    qt = torch.from_numpy(q).to(dev)
    timing_q = [torch.from_numpy(np.concatenate([
        rng.choice(keys_np, Q // 2),
        rng.integers(1, 1 << 62, size=Q // 2)])).to(dev) for _ in range(64)]
    out = {}
    err = scan_edges(dev)
    search_rounds("scan_window", keys_np, np.concatenate(
        [q] + [t.cpu().numpy() for t in timing_q[:4]]))
    for width in (1, 128):
        counts = (np.ones(Q, np.int32) if width == 1 else
                  rng.integers(1, 101, size=Q).astype(np.int32))
        counts[::97] = 0
        ct = torch.from_numpy(counts).to(dev)
        got = kscan.scan_window(qt, ct, keys, vals, max_count=width)
        torch.cuda.synchronize()
        plain = kscan.scan_window_plain(qt, ct, keys, vals, max_count=width)
        err = max(err, compare(f"scan_window (C={width})", got, plain))
        neg = int(np.nonzero(q == HIGH)[0][0])
        check(int(got[1][neg, 0]) == (int(keys_np[0]) if counts[neg] else 0),
              "scan_window: a start of 2^63 did not get lower bound 0")
        say(f"scan_window (C={width}): bit-identical to its plain version "
            f"on {Q} queries ({int(got[0].sum())} valid lanes)")
        timing = [(t, torch.from_numpy(
            rng.integers(1, 101, size=Q).astype(np.int32)
            if width > 1 else np.ones(Q, np.int32)).to(dev))
            for t in timing_q]
        timed = time_kernel(
            f"scan_window (C={width})",
            lambda a, c: kscan.scan_window(a, c, keys, vals,
                                           max_count=width),
            lambda a, c: kscan.scan_window_plain(a, c, keys, vals,
                                                 max_count=width), timing)
        bms, by = scan_bound(keys_np, q, counts, width)
        say(f"scan_window (C={width}): bound {bms:.9f} ms ({by}) at Q={Q}")
        out[width] = (timed, bms, by)
    lib_dev, lib_call = time_calls(
        lambda a, c: torch.searchsorted(keys, a), timing, 640)
    library_ms = lib_dev if lib_dev is not None else lib_call
    say(f"torch.searchsorted (the lower bound alone): device {lib_dev} ms, "
        f"call {lib_call:.6f} ms; main-path launches "
        f"{launches['scan_window']}")
    by_width = {int(name.split("C=")[1]): n for name, n in launches.items()
                if name.startswith("scan_window C=")}
    for width in (1, 128):
        timed, bms, by = out[width]
        say(f"scan_window (C={width}): {timed['ms']} ms, bound {bms:.9f} "
            f"ms ({by}), torch.searchsorted {library_ms} ms, plain "
            f"{timed['plain_ms']} ms; main-path launches at C={width} "
            f"{by_width.get(width, 0)} of {launches['scan_window']}")
    say(f"scan_window main-path launches by window: {by_width}; "
        "scan_window_sharded: " + str({
            int(name.split("C=")[1]): n for name, n in launches.items()
            if name.startswith("scan_window_sharded C=")}))
    timed, bms, by = out[128]
    return [row("scan_window", launches, err, timed, bms, by, library_ms,
                f"P-Masstree, Q={Q}, C=128, n={keys_np.size}")]


def mesh_queries(stacked, c_keys: np.ndarray, n: int, rng) -> tuple:
    """A mesh plan's queries (loaded keys, misses, key 0 and keys of
    2^63 and above), each row's shard by the path's hash route, and its
    run's base and length in the stacked runs."""
    edge = np.array([0, HIGH, -1, (1 << 63) - 1], np.int64)
    q = np.concatenate([rng.choice(c_keys, n // 2),
                        rng.integers(1, 1 << 62, size=n - n // 2 - 4),
                        edge])
    rng.shuffle(q)
    shard = kpart.route_ref(q, SHARDS, "hash")
    base = stacked.offsets[:-1][shard]
    return q, shard, base, stacked.n[shard]


def sharded_scan_vs_plain(scale, seed: int, launches: dict) -> list:
    """scan_window with the shard axis on the stacked runs the P-CLHT x8
    mesh path searched, at windows of 1 (the mesh lookups) and 128;
    ``torch.searchsorted`` over the runs as a 2-D [S, N] array (padded
    to the longest run) is timed as the library call for the lower
    bound."""
    idx = scale["session"].index
    check(idx._mesh_cache is not None, "the mesh path left no stacked "
          "runs on the card")
    stacked = idx._mesh_cache[1]
    dev = stacked.keys.device
    keys_np = stacked.keys.cpu().numpy()
    say(f"P-CLHT x{SHARDS} stacked runs: {keys_np.size} entries, runs of "
        f"{int(stacked.n.min())}-{int(stacked.n.max())}, "
        f"{2 * stacked.keys.numel() * 8} bytes on {dev}")
    rng = np.random.default_rng(seed + 5)
    q, shard, base, length = mesh_queries(stacked, scale["c_keys"], Q, rng)

    def on_card(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    err = 0
    out = {}
    search_rounds("scan_window_sharded", keys_np, q, base, length)
    for width in (1, 128):
        counts = (np.ones(Q, np.int32) if width == 1 else
                  rng.integers(1, 101, size=Q).astype(np.int32))
        qt, ct, bt, lt = on_card(q, counts, base, length)
        got = kscan.scan_window_rows(qt, ct, bt, lt, stacked.keys,
                                     stacked.vals, max_count=width)
        torch.cuda.synchronize()
        plain = kscan.scan_window_rows_plain(qt, ct, bt, lt, stacked.keys,
                                             stacked.vals, max_count=width)
        err = max(err, compare(f"scan_window_sharded (C={width})", got,
                               plain))
        found = int((got[0][:, 0] & (got[1][:, 0] == qt)).sum())
        check(found >= Q // 2, "scan_window_sharded: drawn hits were not "
              "found")
        say(f"scan_window_sharded (C={width}): bit-identical to its plain "
            f"version on {Q} queries over {SHARDS} runs ({found} found)")
        if width == 1:
            timing = []
            for _ in range(64):
                tq, _, tb, tl = mesh_queries(stacked, scale["c_keys"], Q,
                                             rng)
                timing.append(on_card(tq, counts, tb, tl))
            timed = time_kernel(
                "scan_window_sharded (C=1)",
                lambda a, c, b, n: kscan.scan_window_rows(
                    a, c, b, n, stacked.keys, stacked.vals, max_count=1),
                lambda a, c, b, n: kscan.scan_window_rows_plain(
                    a, c, b, n, stacked.keys, stacked.vals, max_count=1),
                timing)
            out = (timed, *scan_bound(keys_np, q, counts, 1, base, length))
    n_max = int(stacked.n.max())
    runs2d = torch.full((SHARDS, n_max), (1 << 63) - 1, dtype=torch.int64,
                        device=dev)
    for s in range(SHARDS):
        lo, hi = stacked.offsets[s], stacked.offsets[s + 1]
        runs2d[s, :hi - lo] = stacked.keys[lo:hi]
    lib_batches = []
    for tq, _, tb, _ in timing:
        rows = torch.from_numpy(kpart.route_ref(tq.cpu().numpy(), SHARDS,
                                                "hash")).to(dev)
        width = int(torch.bincount(rows, minlength=SHARDS).max())
        grid = torch.full((SHARDS, width), 0, dtype=torch.int64, device=dev)
        order = torch.argsort(rows, stable=True)
        slot = torch.arange(Q, device=dev) - torch.searchsorted(
            rows[order], rows[order])
        grid[rows[order], slot] = tq[order]
        lib_batches.append((grid,))
    lib_dev, lib_call = time_calls(
        lambda g: torch.searchsorted(runs2d, g), lib_batches, 640)
    library_ms = lib_dev if lib_dev is not None else lib_call
    timed, bms, by = out
    say(f"scan_window_sharded (C=1): bound {bms:.9f} ms ({by}) at Q={Q}; "
        f"torch.searchsorted over [{SHARDS}, {n_max}] runs: device "
        f"{lib_dev} ms, call {lib_call:.6f} ms; main-path launches "
        f"{launches['scan_window_sharded']}")
    return [row("scan_window_sharded", launches, err, timed, bms, by,
                library_ms, f"P-CLHT x{SHARDS} mesh, Q={Q}, C=1, "
                f"{keys_np.size} entries in {SHARDS} runs")]


def route_vs_plain(scale, launches: dict) -> list:
    """shard_route against its plain version and the numpy oracle on a
    plan's keys plus key 0 and keys of 2^63 and above: hash, prefix and
    prefix@58, 1 to 32 shards; timed at the path's shape (8 shards,
    hash) on the keys of 16 YCSB-C plans."""
    dev = scale["session"].device
    c_keys = scale["c_keys"]
    edge = np.array([0, 1, HIGH, -1, (1 << 63) - 1], np.int64)
    q = np.concatenate([c_keys[:Q - edge.size], edge])
    qt = torch.from_numpy(q).to(dev)
    err = 0
    for scheme in ("hash", "prefix", "prefix@58"):
        for bits in range(6):
            b, shift = kpart.route_params(1 << bits, scheme)
            got = kpart.shard_route(qt, bits=b, shift=shift)
            torch.cuda.synchronize()
            plain = kpart.shard_route_plain(qt, bits=b, shift=shift)
            err = max(err, compare("shard_route", [got], [plain]))
            check(np.array_equal(got.cpu().numpy(), kpart.route_ref(
                q, 1 << bits, scheme)), "shard_route: differs from the "
                "numpy oracle")
    say(f"shard_route: bit-identical to its plain version and to the numpy "
        f"oracle on {Q} keys, hash, prefix and prefix@58, 1-32 shards")
    b, shift = kpart.route_params(SHARDS, "hash")
    timing = [(torch.from_numpy(c_keys[i * Q:(i + 1) * Q]).to(dev),)
              for i in range(max(1, min(16, c_keys.size // Q)))]
    timed = time_kernel(
        "shard_route", lambda k: kpart.shard_route(k, bits=b, shift=shift),
        lambda k: kpart.shard_route_plain(k, bits=b, shift=shift), timing)
    # each key read once (8 bytes), each id written once (4); splitmix64
    # and the shift are about 16 integer operations a key
    bms, by = bound(Q * 12, Q * 16)
    say(f"shard_route: bound {bms:.9f} ms ({by}) at Q={Q}; main-path "
        f"launches {launches['shard_route']}")
    return [row("shard_route", launches, err, timed, bms, by, None,
                f"P-CLHT x{SHARDS}, Q={Q}, hash, {b} bits"),
            partition_vs_plain(q, timing, launches)]


def partition_vs_plain(q: np.ndarray, timing: list, launches: dict
                       ) -> dict:
    """shard_partition against its plain version and the numpy
    partition on the route check's keys and on 1 and 4097 of them
    (both forms), hash, prefix and prefix@58, 1 to 2^12 shards; timed
    at the path's shape (8 shards, hash) on the keys of 16 YCSB-C plans;
    a stable torch.sort of the ids and a bincount timed as the library
    yardstick of the partition half."""
    dev = timing[0][0].device
    err = 0
    for n in (Q, 1, Q + 1):
        keys = np.resize(q, n)
        kt = torch.from_numpy(keys).to(dev)
        for scheme in ("hash", "prefix", "prefix@58"):
            for bits in range(kpart.MAX_PARTITION_BITS + 1):
                b, shift = kpart.route_params(1 << bits, scheme)
                got = kpart.shard_partition(kt, bits=b, shift=shift)
                torch.cuda.synchronize()
                plain = kpart.shard_partition_plain(kt, bits=b, shift=shift)
                err = max(err, compare("shard_partition", got, plain))
                ref = kpart.partition_ref(keys, 1 << bits, scheme)
                check(all(np.array_equal(g.cpu().numpy(), r)
                          for g, r in zip(got, ref)),
                      "shard_partition: differs from the numpy partition")
    say(f"shard_partition: bit-identical to its plain version and to the "
        f"numpy partition on {Q}, 1 and {Q + 1} keys, hash, prefix and "
        f"prefix@58, 1-{1 << kpart.MAX_PARTITION_BITS} shards")
    b, shift = kpart.route_params(SHARDS, "hash")
    timed = time_kernel(
        "shard_partition",
        lambda k: kpart.shard_partition(k, bits=b, shift=shift),
        lambda k: kpart.shard_partition_plain(k, bits=b, shift=shift),
        timing)
    ids = [(kpart.shard_route(k, bits=b, shift=shift),) for (k,) in timing]
    lib_dev, lib_call = time_calls(
        lambda i: (torch.sort(i, stable=True),
                   torch.bincount(i, minlength=SHARDS)), ids, 640)
    library_ms = lib_dev if lib_dev is not None else lib_call
    # each key read once (8 bytes), its id and its place written once (4
    # and 4), the offsets; a route and a rank are some 24 operations
    bms, by = bound(Q * 16 + (SHARDS + 1) * 4, Q * 24)
    say(f"shard_partition: bound {bms:.9f} ms ({by}) at Q={Q}, "
        f"S={SHARDS}; torch.sort(stable) + bincount of the ids: device "
        f"{lib_dev} ms, call {lib_call:.6f} ms; main-path launches "
        f"{launches['shard_partition']}")
    return row("shard_partition", launches, err, timed, bms, by,
               library_ms, f"P-CLHT x{SHARDS}, Q={Q}, hash, {b} bits")


def conflict_edges(dev) -> int:
    """conflict_any against its plain version and the numpy oracle on
    keys 0, -1, INT64_MIN and INT64_MAX, reference sets of 1, 7, 12288
    and 65536 with no SCAN, no write or only GETs, and one key many
    times over, writes_conflict both ways."""
    rng = np.random.default_rng(11)
    edges = np.array([0, -1, HIGH, (1 << 63) - 1, 1], np.int64)
    err = 0
    for n_b in (1, 7, 12288, 65536):
        n_a = 1024 if n_b > 12288 else Q
        pool = np.concatenate([edges, rng.integers(
            HIGH, (1 << 63) - 1, size=max(8, n_b // 3))])
        for case, kinds_b in (("edges", (0, 1, 2, 3, 4, 5)),
                              ("no SCAN", (0, 1, 2, 3, 5)),
                              ("no write", (0, 4, 5)), ("only GETs", (0,)),
                              ("one key", (0, 1, 2, 3, 4, 5))):
            ka = rng.integers(0, 6, size=n_a).astype(np.int32)
            kb = rng.choice(np.array(kinds_b, np.int32), size=n_b)
            xa, xb = rng.choice(pool, n_a), rng.choice(pool, n_b)
            if case == "edges":
                xa[::2] = np.resize(edges, xa[::2].size)
                xb[:] = np.resize(edges, n_b)
            if case == "one key":
                xb[:] = xa[3]
            t = [torch.from_numpy(a).to(dev) for a in (ka, xa, kb, xb)]
            for wc in (False, True):
                got = kconf.kernel.conflict_any(*t, writes_conflict=wc)
                torch.cuda.synchronize()
                err = max(err, compare(f"conflict_any ({case}, B={n_b})",
                                       [got], [kconf.conflict_any_plain(
                                           *t, writes_conflict=wc)]))
                check(np.array_equal(got.cpu().numpy(),
                                     kconf.conflict_any_ref(
                                         ka, xa, kb, xb,
                                         writes_conflict=wc)),
                      f"conflict_any ({case}, B={n_b}): differs from the "
                      "numpy oracle")
    say("conflict_any: bit-identical to its plain version and to the numpy "
        "oracle on keys 0, -1, INT64_MIN and INT64_MAX, B = 1, 7, 12288 "
        "and 65536, no SCAN, no write, only GETs, one key many times over, "
        "writes_conflict both ways")
    return err


def conflict_vs_plain(scale, launches: dict) -> list:
    """conflict_any against its plain version and the numpy oracle on
    the admission checks the stream phase made (the largest reference
    set last), writes_conflict both ways, for reference sets of 1 up
    to the largest; timed on the checks of the largest reference set."""
    dev = scale["session"].device
    checks = scale["checks"]

    def on_card(ka, xa, kb, xb):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (ka.astype(np.int32), xa,
                               kb.astype(np.int32), xb))

    ka, xa, kb, xb = checks[-1]
    b_max = kb.size
    err = 0
    for wc in (False, True):
        for nb in sorted({1, 7, 64, PLAN_OPS, b_max} & set(
                range(1, b_max + 1))):
            t = on_card(ka, xa, kb[:nb], xb[:nb])
            got = kconf.kernel.conflict_any(*t, writes_conflict=wc)
            torch.cuda.synchronize()
            plain = kconf.conflict_any_plain(*t, writes_conflict=wc)
            err = max(err, compare("conflict_any", [got], [plain]))
            check(np.array_equal(got.cpu().numpy(), kconf.conflict_any_ref(
                ka, xa, kb[:nb], xb[:nb], writes_conflict=wc)),
                "conflict_any: differs from the numpy oracle")
    err = max(err, conflict_edges(dev))
    n_conf = 0
    for c in checks:  # every admission check of the path, as it ran
        t = on_card(*c)
        got = kconf.kernel.conflict_any(*t, writes_conflict=True)
        torch.cuda.synchronize()
        err = max(err, compare("conflict_any", [got], [
            kconf.conflict_any_plain(*t, writes_conflict=True)]))
        n_conf += int(got.sum())
    check(n_conf > 0, "conflict_any: no admission check found a conflict")
    say(f"conflict_any: bit-identical to its plain version and to the "
        f"numpy oracle, A={ka.size}, B=1..{b_max}, writes_conflict both "
        f"ways; and on all {len(checks)} admission checks of the path "
        f"({n_conf} conflicting candidates)")
    timing = [on_card(*c) for c in checks if c[2].size == b_max]
    timed = time_kernel(
        "conflict_any",
        lambda *t: kconf.kernel.conflict_any(*t, writes_conflict=True),
        lambda *t: kconf.conflict_any_plain(*t, writes_conflict=True),
        timing, reps=320)
    # the function's bytes: each op's kind and key read once, each
    # candidate's answer written once; the work is a hash and a compare
    # or two an op, about 12 integer operations (the design before this
    # one ran a pair test of some 12 operations for each candidate up to
    # its first conflict, or all of B)
    conf = kconf.conflict_matrix_ref(ka, xa, kb, xb, writes_conflict=True)
    pairs = int(np.where(conf.any(axis=1), conf.argmax(axis=1) + 1,
                         b_max).sum())
    bms, by = bound((ka.size + b_max) * 12 + ka.size,
                    (ka.size + b_max) * 12)
    say(f"conflict_any: bound {bms:.9f} ms ({by}) at A={ka.size}, "
        f"B={b_max} ({int(conf.any(axis=1).sum())} candidates "
        f"conflict; the pair-test design's bound counted {pairs} pair "
        f"tests: {bound(0, pairs * 12)[0]:.9f} ms); main-path launches "
        f"{launches['conflict_any']}")
    return [row("conflict_any", launches, err, timed, bms, by, None,
                f"{STREAMS}-stream tick, A={ka.size}, B={b_max}")]


# -- the serving path -------------------------------------------------------

def serve_prompts(vocab: int, seed: int) -> list:
    """16 prompts of 256-512 tokens sharing a 128-token prefix."""
    rng = np.random.default_rng(seed + 11)
    prefix = rng.integers(1, vocab, SERVE_PREFIX).tolist()
    return [prefix + rng.integers(1, vocab, int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)) - SERVE_PREFIX).tolist()
        for _ in range(SERVE_REQUESTS)]


def drive_server(server, phases: list, *, pipelined: bool, tag: str):
    """Submit each phase's prompts through 2 sessions and drain; before
    every phase but the first the server power-fails and recovers.
    Returns the requests, per-phase measurements and the PMem-load
    check."""
    sessions = [server.connect() for _ in range(SERVE_SESSIONS)]
    reqs, first_tok, phases_out = [], {}, []
    steady = 0
    for phase, batch in enumerate(phases):
        if phase:
            hits_before = server.stats["prefix_hits"]
            server.crash_and_recover()
            restored = server.stats["warm_prefixes_restored"]
            check(restored > 0, f"{tag}: no warm prefix survived the crash")
        for i, p in enumerate(batch):
            sessions[i % SERVE_SESSIONS].submit(p, max_new=SERVE_NEW)
            reqs.append(server.queue[-1])
        RECORDER.reset()
        t0 = time.perf_counter()
        while server.queue or server.running:
            admitting = bool(server.queue)
            loads = server.pmem.counters.loads
            server.step(SERVE_MAX_LEN, pipelined=pipelined)
            now = time.perf_counter()
            if not admitting:
                steady += 1
                check(server.pmem.counters.loads == loads,
                      f"{tag}: a steady decode tick loaded PMem words")
            for r in reqs:
                if r.out and r.rid not in first_tok:
                    first_tok[r.rid] = now - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        admit_ns = sum(sp.dur for sp in RECORDER.find("serve.admit"))
        decode_ns = sum(sp.dur for sp in RECORDER.find("serve.decode"))
        phases_out.append({"wall": wall, "admit_s": admit_ns / 1e9,
                           "decode_s": decode_ns / 1e9})
        if phase:
            check(server.stats["prefix_hits"] > hits_before,
                  f"{tag}: the recovered server hit no warm prefix")
    check(all(r.done and len(r.out) == SERVE_NEW for r in reqs),
          f"{tag}: a request did not finish with {SERVE_NEW} tokens")
    check(steady > 0, f"{tag}: no steady decode tick ran")
    return reqs, first_tok, phases_out, steady


def prefilled(model, prompt: list):
    """One request's prefill on ``model``: the logits and the caches
    ``decode_step`` continues from (k and v padded to the serving path's
    slots, as the engine pads them; recurrent state as it comes)."""
    dev = model.device
    logits, caches = model.prefill(
        {"tokens": torch.tensor([prompt], device=dev)}, len(prompt))
    return logits, _pad_caches(caches, len(prompt), SERVE_SLOTS)


def logit_runs(models: list, prompt: list) -> list:
    """One request's prefill logits and 4 decode steps on each model (the
    first model's greedy tokens fed to all), as fp32 CPU tensors."""
    runs = []
    for model in models:
        logits, caches = prefilled(model, prompt)
        runs.append((model, [logits.float().cpu()], caches))
    tokens = [int(torch.argmax(runs[0][1][0][0]))]
    for step in range(4):
        pos = len(prompt) + step
        for model, out, caches in runs:
            dev = model.device
            logits, _ = model.decode_step(
                torch.tensor([tokens[-1]], device=dev), caches,
                torch.tensor([pos], device=dev), page_size=SERVE_PAGE)
            out.append(logits.float().cpu())
        tokens.append(int(torch.argmax(runs[0][1][-1][0])))
    for out in runs:
        check(all(bool(torch.isfinite(x).all()) for x in out[1]),
              "serving: non-finite logits")
    return [out for _, out, _ in runs]


def worst_rel(got: list, want: list) -> float:
    """The largest difference over the largest logit, over every step."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def serving_path(arch: str, seed: int, extra: tuple = (), *,
                 reduced: bool = False) -> dict:
    """The serving workload on ``arch`` at full width (or at its
    ``reduced()`` widths); ``extra`` prompt lengths join the last
    phase."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    say(f"serving: {cfg.name} at {'reduced' if reduced else 'full'} width "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"/ {cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}"
        + (f"; layers {layer_kinds(cfg)}" if cfg.family == "hybrid" else "")
        + f"): {n_params} parameters, {n_bytes} bytes on {lm.device}, drawn "
        f"in {time.perf_counter() - t0:.3f} s")
    prompts = serve_prompts(cfg.vocab, seed)
    rng = np.random.default_rng(seed + 14)
    extra_prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in extra]
    half = len(prompts) // 2
    phases = [prompts[:half], prompts[half:] + extra_prompts]
    n_reqs = len(prompts) + len(extra_prompts)
    RECORDER.enable()
    runs = {}
    try:
        with counting_plain() as plain_calls:
            for mode in ("blocking", "pipelined"):
                server = Server(lm, max_batch=SERVE_BATCH,
                                page_size=SERVE_PAGE, n_pages=SERVE_PAGES)
                check(server.kv.table.device == lm.device ==
                      server.kv.prefix.device, "serving: the block table or "
                      "prefix cache is not on the model's device")
                tag = f"serving {cfg.name} ({mode})"
                runs[mode] = (server,) + drive_server(
                    server, phases, pipelined=mode == "pipelined", tag=tag)
    finally:
        RECORDER.disable()
    check(not any(plain_calls.values()), f"serving {cfg.name}: a plain "
          f"kernel version ran on the path: {plain_calls}")
    blocking, pipelined = runs["blocking"], runs["pipelined"]
    check([r.out for r in pipelined[1]] == [r.out for r in blocking[1]],
          f"serving {cfg.name}: pipelined tokens differ from blocking tokens")
    check(all(0 <= t < cfg.vocab for r in blocking[1] for t in r.out),
          f"serving {cfg.name}: a token outside the vocabulary")
    check(blocking[0].stats["decode_steps"] == n_reqs * (SERVE_NEW - 1),
          f"serving {cfg.name}: decode steps differ from "
          f"{SERVE_NEW - 1} per request")
    for mode, (server, reqs, first_tok, phases_out, steady) in runs.items():
        st = server.stats
        admit_s = sum(p["admit_s"] for p in phases_out)
        decode_s = sum(p["decode_s"] for p in phases_out)
        ttft = np.array([first_tok[r.rid] for r in reqs]) * 1e3
        say(f"serving {cfg.name} ({mode}): {len(reqs)} requests, "
            f"{sum(len(r.prompt) for r in reqs)} prompt tokens, "
            f"{st['prefill_tokens']} prefilled, {st['prefix_hits']} prefix "
            f"hits, {st['decode_steps']} decode steps in "
            f"{sum(p['wall'] for p in phases_out):.3f} s wall; prefill "
            f"{st['prefill_tokens'] / admit_s:.1f} tokens/s "
            f"(serve.admit spans, {admit_s:.3f} s); decode "
            f"{st['decode_steps'] / decode_s:.1f} tokens/s (serve.decode "
            f"spans, {decode_s:.3f} s); time to first token p50 "
            f"{np.percentile(ttft, 50):.3f} ms, max {ttft.max():.3f} ms "
            f"(tick granularity); warm_prefixes_restored "
            f"{st['warm_prefixes_restored']}, "
            f"recovery_time_to_first_served_us "
            f"{st['recovery_time_to_first_served_us']}; page_translations "
            f"{st['page_translations']} in {st['translation_batches']} "
            f"batches; {steady} steady decode ticks moved no PMem loads; "
            f"PMem {server.pmem.counters}")
    say(f"serving {cfg.name}: pipelined tokens equal blocking tokens for "
        f"all {len(blocking[1])} requests")
    lens = [r.pos for r in blocking[1]]
    return {"cfg": cfg, "lm": lm, "prompts": prompts + extra_prompts,
            "decode_lens": (min(lens), max(lens)),
            "prefills": 2 * n_reqs,
            "decode_steps": sum(run[0].stats["decode_steps"]
                                for run in runs.values())}


def serving_cpu_check(serve: dict, prompt: list) -> None:
    """The card against the CPU's plain versions on the same weights.
    Qwen2-0.5B (dense): the served bf16 model on both.  RWKV6-7B and the
    hybrid: the weights upcast to fp32 on both, and the served bf16 card
    run beside them."""
    t0 = time.perf_counter()
    lm, name = serve["lm"], serve["cfg"].name
    if lm.cfg.family == "dense":
        card, cpu = logit_runs([lm, copy.deepcopy(lm).cpu()], prompt)
        rel, tol, what = worst_rel(card, cpu), LOGIT_REL_TOL, "bf16"
        extra = ""
    else:
        card16, card, cpu = logit_runs(
            [lm, copy.deepcopy(lm).float(), copy.deepcopy(lm).cpu().float()],
            prompt)
        rel, tol, what = worst_rel(card, cpu), FP32_LOGIT_REL_TOL, "fp32"
        extra = (f"; the served bf16 card run against the fp32 CPU run: "
                 f"{worst_rel(card16, cpu):.6f} (bf16 rounding, not gated)")
        torch.cuda.empty_cache()
    check(rel <= tol, f"serving {name}: card logits differ from the CPU's "
          f"by {rel:.6f} of the largest logit ({what}, tolerance {tol})")
    say(f"serving {name}: prefill ({len(prompt)} tokens) and 4 decode steps "
        f"on the card against the CPU's plain versions, {what}: max |diff| "
        f"/ max |logit| = {rel:.6f} (tolerance {tol}){extra}; "
        f"{time.perf_counter() - t0:.3f} s")


def decode_busy(serve: dict, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` steps of one request
    at B = 1, as the engine runs them, timed on the host clock (each
    step ends in the argmax that syncs), then the same steps under the
    profiler for the summed device time and the count of CUDA kernels a
    step.  Busy share = device time over host time."""
    lm = serve["lm"]
    prompt = max(serve["prompts"], key=len)
    dev = lm.device
    logits, caches = prefilled(lm, prompt)
    tok = int(torch.argmax(logits[0]))

    def run(first: int) -> int:
        t = tok
        for pos in range(first, first + steps):
            out, _ = lm.decode_step(torch.tensor([t], device=dev), caches,
                                    torch.tensor([pos], device=dev),
                                    page_size=SERVE_PAGE)
            t = int(torch.argmax(out[0]))
        return t

    run(len(prompt))  # warm-up
    t0 = time.perf_counter()
    run(len(prompt))
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(len(prompt))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    n = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:4]
    say(f"serving {serve['cfg'].name} decode, B=1, position {len(prompt)}: "
        f"{host_ms:.3f} ms a step on the host clock, {dev_ms:.3f} ms of "
        f"device time in {n:.0f} CUDA kernels a step; device busy share "
        f"{dev_ms / host_ms:.4f}; top kernels: " + "; ".join(
            f"{e.key[:50]} {e.device_time_total / 1e3 / steps:.4f} ms"
            for e in top))


def attn_bound(n_bytes: float, flops: float):
    """Least time in ms: bytes over HBM bandwidth against FLOPs over the
    bf16 tensor-core rate, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attn_limit(plain: torch.Tensor) -> torch.Tensor:
    """The elementwise limit of ``ATTN_STEPS`` (see there)."""
    p = plain.float().abs()
    return ATTN_STEPS * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())


def close(name: str, got, plain, dropped,
          variant: str = "a dropped newest key") -> float:
    """Max abs error of ``got`` against ``plain`` within ``attn_limit``;
    ``dropped`` is a broken plain version (by default without each row's
    newest key), which must break the limit."""
    limit = attn_limit(plain)
    diff = (got.float() - plain.float()).abs()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite "
          "output")
    check(bool((diff <= limit).all()), f"{name}: kernel differs from its "
          f"plain version by up to {float((diff / limit).max())} times the "
          f"limit of {ATTN_STEPS} bf16 unit roundoffs")
    caught = int(((dropped.float() - plain.float()).abs() > limit).sum())
    check(caught > 0, f"{name}: the limit does not see {variant}")
    err = float(diff.max())
    say(f"{name}: within {ATTN_STEPS} bf16 unit roundoffs of its plain "
        f"version elementwise (max abs err {err:.6f}, largest |plain| "
        f"{float(plain.float().abs().max()):.6f}); {variant} "
        f"breaks the limit at {caught} of {plain.numel()} elements (max "
        f"abs {float((dropped.float() - plain.float()).abs().max()):.6f})")
    return err


def flash_vs_plain(serve: dict, seed: int, launches: dict) -> list:
    """flash_attention at the prefill shapes (T = S = 256 and 512, the
    full width's heads, bf16); ``scaled_dot_product_attention`` on the
    same inputs (kv heads repeated beforehand) is the library call."""
    cfg = serve["cfg"]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = serve["lm"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    out = None
    err = 0.0
    for T in SERVE_PROMPT:
        batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                         .to(torch.bfloat16)
                         for shape in ((1, T, H, dh), (1, T, Hk, dh),
                                       (1, T, Hk, dh)))
                   for _ in range(8)]
        q, k, v = batches[0]
        got = kflash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        plain = kflash.attention_plain(q, k, v)
        # query i + 1 without key i + 1: the diagonal key dropped
        dropped = torch.cat([plain[:, :1], kflash.attention_plain(
            q[:, 1:], k[:, :-1], v[:, :-1])], dim=1)
        err = max(err, close(f"flash_attention (T={T})", got, plain,
                             dropped))
        timed = time_kernel(f"flash_attention (T={T})",
                            lambda a, b, c: kflash.flash_attention(a, b, c),
                            lambda a, b, c: kflash.attention_plain(a, b, c),
                            batches, reps=64)
        lib = [(a.transpose(1, 2).contiguous(),
                b.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous(),
                c.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous()) for a, b, c in batches]
        lib_dev, lib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=True), lib, 64)
        library_ms = lib_dev if lib_dev is not None else lib_call
        n_bytes = 2 * (2 * T * H * dh + 2 * T * Hk * dh)
        bms, by = attn_bound(n_bytes, 2 * 2 * T * T * dh * H / 2)
        say(f"flash_attention (T={T}): bound {bms:.9f} ms ({by}); "
            f"scaled_dot_product_attention: device {lib_dev} ms, call "
            f"{lib_call:.6f} ms")
        out = (timed, bms, by, library_ms, T)
    timed, bms, by, library_ms, T = out
    say(f"flash_attention: main-path launches {launches['flash_attention']}")
    return [row("flash_attention", launches, err, timed, bms, by, library_ms,
                f"{cfg.name} prefill, T=S={T}, H={H}, Hk={Hk}, dh={dh}, "
                "bf16")]


def paged_vs_plain(serve: dict, seed: int, launches: dict) -> list:
    """paged_attention at the decode shapes: one sequence, the full
    width's heads, the path's dense cache of S_pad slots read as pages
    through the identity table, at the shortest and longest length a
    request reached; ``scaled_dot_product_attention`` over the live
    keys (kv heads repeated beforehand) is the library call."""
    cfg = serve["cfg"]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slots = SERVE_SLOTS
    n_pages = slots // SERVE_PAGE
    dev = serve["lm"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    pages, n_splits = kpaged.split_plan(
        n_pages, 1, H, Hk, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    say(f"paged_attention: {n_splits} splits of {pages} pages (one cluster "
        f"a kv head), {n_splits * Hk} blocks")
    err = 0.0
    out = None
    for length in serve["decode_lens"]:
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                         .to(torch.bfloat16)
                         for shape in ((1, H, dh), (n_pages, SERVE_PAGE, Hk,
                                                    dh),
                                       (n_pages, SERVE_PAGE, Hk, dh)))
                   for _ in range(8)]
        q, pk, pv = batches[0]
        got = kpaged.paged_mqa(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        err = max(err, close(
            f"paged_attention (len={length}, {slots} slots)", got,
            kpaged.paged_attention_plain(q, pk, pv, table, lens),
            kpaged.paged_attention_plain(q, pk, pv, table, lens - 1)))
        timed = time_kernel(
            f"paged_attention (len={length})",
            lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens),
            lambda a, b, c: kpaged.paged_attention_plain(a, b, c, table,
                                                         lens),
            batches, reps=256)
        lib = [(a[:, :, None],
                b.reshape(1, slots, Hk, dh)[:, :length]
                .repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous(),
                c.reshape(1, slots, Hk, dh)[:, :length]
                .repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous()) for a, b, c in batches]
        lib_dev, lib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c), lib, 256)
        library_ms = lib_dev if lib_dev is not None else lib_call
        # the live keys and values once, q, the table row, the output
        n_bytes = 2 * (2 * length * Hk * dh + 2 * H * dh) + 4 * n_pages + 4
        bms, by = attn_bound(n_bytes, 4 * length * H * dh)
        say(f"paged_attention (len={length}): bound {bms:.9f} ms ({by}); "
            f"scaled_dot_product_attention: device {lib_dev} ms, call "
            f"{lib_call:.6f} ms")
        out = (timed, bms, by, library_ms, length)
    timed, bms, by, library_ms, length = out
    say(f"paged_attention: main-path launches {launches['paged_attention']}")
    return [row("paged_attention", launches, err, timed, bms, by, library_ms,
                f"{cfg.name} decode, B=1, H={H}, Hk={Hk}, dh={dh}, "
                f"len={length}, {slots} slots, bf16")]


# -- the tag path and its kernel --------------------------------------------

def tag_queries(tags: np.ndarray, rng) -> np.ndarray:
    """Q queries: stored tags, random int32 (mostly misses), query 0 and
    the two colliding keys' shared tag."""
    hits = tags[rng.integers(0, tags.shape[0], Q - 1024)]
    misses = rng.integers(-(1 << 31), 1 << 31, 1024 - 8).astype(np.int32)
    return np.concatenate([hits, misses, np.zeros(4, np.int32),
                           np.repeat(tags[[0, -1]], 2)]).astype(np.int32)


def tag_path(seed: int) -> dict:
    """The 32-bit tag data plane (``kernels/clht_probe`` ``tag_lookup``):
    ``TAG_KEYS`` 64-bit keys drawn from the seed, stored under their low
    32 bits as int32 tags in a chained table of ``TAG_BUCKETS`` buckets
    built on the host and uploaded to the card; the last key shares its
    tag with the first (a tag collision).  One wave of Q queries: every
    answer equals the numpy reading, query 0 is found with value 0, both
    colliding keys read the first key's value, and every stored tag reads
    back its first value."""
    rng = np.random.default_rng(seed + 15)
    keys64 = rng.integers(1, 1 << 62, size=TAG_KEYS, dtype=np.int64)
    keys64[-1] = keys64[0] ^ (1 << 40)
    tags = (keys64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    values = rng.integers(1, 1 << 31, size=TAG_KEYS).astype(np.int32)
    t0 = time.perf_counter()
    host = ktag.tag_table_np(tags, values, TAG_BUCKETS)
    table = [torch.from_numpy(a).cuda() for a in host]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = tag_queries(tags, rng)
    qd = torch.from_numpy(q).cuda()
    t0 = time.perf_counter()
    found, got = ktag.tag_lookup(qd, *table, n_buckets=TAG_BUCKETS)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    found, got = found.cpu().numpy(), got.cpu().numpy()
    nf, nv = ktag.tag_lookup_np(q, *host, TAG_BUCKETS)
    check(np.array_equal(found, nf) and np.array_equal(got, nv),
          "tag path: tag_lookup differs from its numpy reading")
    zero = q == 0
    check(bool(found[zero].all()) and not got[zero].any(),
          "tag path: query 0 is not found with value 0")
    pair = q == tags[0]
    check(bool(found[pair].all()) and bool((got[pair] == values[0]).all()),
          "tag path: a colliding key does not read the first key's value")
    uniq, first = np.unique(tags, return_index=True)
    n_hit = Q - 1024
    want = values[first[np.searchsorted(uniq, q[:n_hit])]]
    check(bool(found[:n_hit].all()) and np.array_equal(got[:n_hit], want),
          "tag path: a stored tag does not read back its first value")
    say(f"tag path: {TAG_KEYS} keys in {TAG_BUCKETS} buckets "
        f"({host[0].shape[0]} rows, {TAG_KEYS - uniq.shape[0]} tags stored "
        f"twice), built and uploaded in {build_s:.3f} s; a wave of {Q} "
        f"queries in {wave_ms:.3f} ms (first call); {int(found.sum())} "
        f"found ({int(found[n_hit:].sum())} of the {Q - n_hit} misses, "
        f"zeros and collisions), every answer equal to the numpy reading")
    return {"table": table, "host": host, "tags": tags, "rng": rng,
            "q": qd, "numpy": (nf, nv)}


def tag_wave_ops(tag: dict) -> None:
    """The device operations of one tag_lookup wave on the tag path's
    table, counted by the profiler: one, the tag probe.  Run after the
    path's counts are read, so its launches count for no path."""
    n_ops, names = device_ops(lambda: ktag.tag_lookup(
        tag["q"], *tag["table"], n_buckets=TAG_BUCKETS))
    check(n_ops <= 1, f"tag path: a tag_lookup wave ran {n_ops:.2f} "
          f"device operations, not one: {names}")
    say(f"tag path: the wave's device operations: {n_ops:.2f} "
        f"({', '.join(names)})")


def device_ops(fn, calls: int = 32) -> tuple:
    """(operations a call, their names) of the device operations ``fn``
    runs: each CUDA kernel, copy and fill the profiler records over
    ``calls`` calls, after a profiled warm-up (the profiler may miss a
    window's first launches, so a count may read low, never high)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for n in (4, calls):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.count
           and not e.key.startswith("ProfilerStep")]
    return (sum(e.count for e in ops) / calls,
            [f"{kernel_name(e.key)} x{e.count / calls:g}" for e in ops])


def tag_walks(q: np.ndarray, host: tuple) -> tuple:
    """(rows each query of the tag probe reads, whether it hit a live
    lane) over the host table: the kernel's walk, vectorized."""
    keys, _, nxt = host
    row = ktag.ref.tag_hash_np(q, TAG_BUCKETS)
    read = np.zeros(q.size, np.int64)
    hit = np.zeros(q.size, bool)
    for _ in range(ktag.ref.CHAIN_DEPTH):
        live = (row >= 0) & ~hit
        safe = np.where(live, row, 0)
        read += live
        hit |= live & (keys[safe] == q[:, None]).any(axis=1)
        row = np.where(live & ~hit, nxt[safe], -1)
    return read, hit


def clht_vs_plain(tag: dict, launches: dict) -> list:
    """clht_probe on the tag path's windows (Q queries of 128 lanes)
    against its plain version and the numpy reading, then timed over 8
    waves of queries."""
    table = tag["table"]
    waves = [tag["q"]] + [torch.from_numpy(tag_queries(tag["tags"],
                                                       tag["rng"])).cuda()
                          for _ in range(7)]
    batches = [(q,) + ktag.tag_windows(q, *table, n_buckets=TAG_BUCKETS)
               for q in waves]
    q, bk, bv = batches[0]
    got = ktag.clht_probe(q, bk, bv)
    torch.cuda.synchronize()
    err = compare("clht_probe", got, ktag.probe_plain(q, bk, bv))
    check(np.array_equal(got[0].cpu().numpy(), tag["numpy"][0]) and
          np.array_equal(got[1].cpu().numpy(), tag["numpy"][1]),
          "clht_probe: kernel differs from tag_lookup's numpy reading")
    say("clht_probe: bit-identical to its plain version and to the numpy "
        f"reading on {Q} queries")
    timed = time_kernel("clht_probe",
                        lambda a, b, c: ktag.clht_probe(a, b, c),
                        lambda a, b, c: ktag.probe_plain(a, b, c), batches)
    # what these queries need: each key lane up to the first hit (all 128
    # on a miss), the hit's value, the query and the two outputs
    hit = bk == q[:, None]
    lanes = torch.where(hit.any(1), hit.to(torch.int8).argmax(1) + 1,
                        bk.shape[1])
    n_lanes = int(lanes.sum())
    n_bytes = 4 * n_lanes + 4 * int(hit.any(1).sum()) + Q * (4 + 1 + 4)
    bms, by = bound(n_bytes, n_lanes)
    say(f"clht_probe: bound {bms:.9f} ms ({by}, {n_bytes} bytes, {n_lanes} "
        f"lane compares); main-path launches {launches['clht_probe']}")
    return [row("clht_probe", launches, err, timed, bms, by, None,
                f"tag path, Q={Q}, W=128, {TAG_BUCKETS} buckets"),
            tag_vs_plain(tag, waves, launches)]


def tag_vs_plain(tag: dict, waves: list, launches: dict) -> dict:
    """tag_probe on the tag path's table against its plain version (the
    windows' gather, then the plain probe) and the numpy reading on 8
    waves; timed over them beside the wave it replaced (the gather and
    the window kernel), each with its device operations counted."""
    table = tag["table"]
    err = 0
    for q in waves:
        got = ktag.tag_probe(q, *table, n_buckets=TAG_BUCKETS)
        torch.cuda.synchronize()
        err = max(err, compare("tag_probe", got, ktag.tag_probe_plain(
            q, *table, n_buckets=TAG_BUCKETS)))
        qn = q.cpu().numpy()
        nf, nv = ktag.tag_lookup_np(qn, *tag["host"], TAG_BUCKETS)
        check(np.array_equal(got[0].cpu().numpy(), nf) and
              np.array_equal(got[1].cpu().numpy(), nv),
              "tag_probe: differs from tag_lookup's numpy reading")
    say(f"tag_probe: bit-identical to its plain version and to the numpy "
        f"reading on {len(waves)} waves of {Q} queries")

    def probe(q):
        return ktag.tag_probe(q, *table, n_buckets=TAG_BUCKETS)

    def plain(q):
        return ktag.tag_probe_plain(q, *table, n_buckets=TAG_BUCKETS)

    def windows_wave(q):
        return ktag.clht_probe(q, *ktag.tag_windows(
            q, *table, n_buckets=TAG_BUCKETS))

    batches = [(q,) for q in waves]
    timed = time_kernel("tag_probe", probe, plain, batches)
    before_dev, before_call = time_calls(windows_wave, batches, 640)
    n_new, _ = device_ops(lambda: probe(waves[0]))
    n_old, _ = device_ops(lambda: windows_wave(waves[0]))
    # what these queries need: each query, the rows it walks (3 keys and
    # the next row, 16 bytes), the hit's value, and the two outputs
    read, hit = tag_walks(waves[0].cpu().numpy(), tag["host"])
    n_bytes = Q * 4 + int(read.sum()) * 16 + int(hit.sum()) * 4 + Q * 5
    bms, by = bound(n_bytes, Q * 6 + int(read.sum()) * 4)
    say(f"tag_probe: bound {bms:.9f} ms ({by}, {n_bytes} bytes); rows a "
        f"query reads: mean {read.mean():.4f}, max {int(read.max())} (a "
        f"round each after the query's own); the wave it replaced "
        f"(tag_windows + clht_probe): device {before_dev} ms, call "
        f"{before_call:.6f} ms, {n_old:.2f} device operations, against "
        f"{n_new:.2f}; main-path launches {launches['tag_probe']}")
    return row("tag_probe", launches, err, timed, bms, by, None,
               f"tag path, Q={Q}, {TAG_BUCKETS} buckets, depth "
               f"{ktag.ref.CHAIN_DEPTH}")


# -- the WKV6 kernel ----------------------------------------------------------

def wkv_draw(gen, T: int, H: int, dh: int, carried: bool) -> tuple:
    """r, k, v [1, T, H, dh] bf16, logw fp32 log-uniform in [-8, -0.001]
    (strong decays included), u [H, dh] and a carried state fp32."""
    dev = gen.device
    r, k, v = (torch.randn((1, T, H, dh), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    lo, hi = np.log(1e-3), np.log(8.0)
    logw = -torch.exp(lo + (hi - lo) * torch.rand(
        (1, T, H, dh), generator=gen, device=dev))
    u = torch.randn((H, dh), generator=gen, device=dev)
    state = torch.randn((1, H, dh, dh), generator=gen, device=dev) \
        if carried else None
    return r, k, v, logw, u, state


def wkv6_vs_plain(serve: dict, seed: int, launches: dict,
                  split: dict) -> list:
    """wkv6 at RWKV6-7B's shapes: a prefill of T = 512 from a zero state
    and a decode step (T = 1) from a carried state, on inputs drawn from
    the seed; elementwise within ``ATTN_STEPS`` bf16 unit roundoffs of
    the plain version, a limit that the plain version without the bonus
    u (prefill) or without the carried state (decode) breaks; the final
    state within 2e-5 of its largest magnitude.  No PyTorch op computes a
    WKV scan: no library call."""
    cfg = serve["cfg"]
    dh = cfg.rwkv.head_dim
    H = cfg.d_model // dh
    dev = serve["lm"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    err = 0.0
    out = None
    for T, carried in ((SERVE_PROMPT[1], False), (1, True)):
        batches = [wkv_draw(gen, T, H, dh, carried) for _ in range(8)]
        r, k, v, logw, u, state = batches[0]
        got, got_state = kwkv.wkv6(r, k, v, logw, u, state)
        torch.cuda.synchronize()
        plain, plain_state = kwkv.wkv6_plain(r, k, v, logw, u, state)
        if carried:
            broken, _ = kwkv.wkv6_plain(r, k, v, logw, u)
            variant = "the plain version without the carried state"
        else:
            broken, _ = kwkv.wkv6_plain(r, k, v, logw, torch.zeros_like(u))
            variant = "the plain version without the bonus u"
        name = f"wkv6 (T={T})"
        err = max(err, close(name, got, plain, broken, variant))
        s_err = float((got_state - plain_state).abs().max())
        s_max = float(plain_state.abs().max())
        check(bool(torch.isfinite(got_state).all()) and
              s_err <= 2e-5 * s_max, f"{name}: the final state differs from "
              f"the plain version's by {s_err} (largest {s_max})")
        say(f"{name}: final state max abs err {s_err:.3e} (largest "
            f"{s_max:.3f}); logw in [{float(logw.min()):.4f}, "
            f"{float(logw.max()):.6f}]")
        if T >= 256:
            sums = logw[0, :T - T % 256].reshape(-1, 256, H, dh).sum(1)
            say(f"{name}: a factored exp(-cum) over chunks of 256 would "
                f"overflow fp32 in {int((sums < -88.7).sum())} of "
                f"{sums.numel()} (chunk, head, channel) columns")
        # the plain recurrence launches some 3,000 small kernels a call
        # at T = 512; the profiler's bookkeeping of 32 such calls takes
        # minutes, and 4 give its device time as well
        timed = time_kernel(name, lambda *a: kwkv.wkv6(*a),
                            lambda *a: kwkv.wkv6_plain(*a), batches,
                            reps=64 if T > 1 else 640,
                            plain_reps=4 if T > 1 else 32)
        n = T * H * dh
        n_bytes = 2 * 4 * n + 4 * n + 4 * H * dh \
            + 4 * H * dh * dh * (2 if carried else 1)
        # the state terms: one FMA a state element for r.S and one for
        # the update, per token and head, at the fp32 rate
        bms, by = bound(n_bytes, 4 * dh * dh * T * H)
        say(f"{name}: bound {bms:.9f} ms ({by}, {n_bytes} bytes)")
        out = out or (timed, bms, by, T)
    timed, bms, by, T = out
    say(f"wkv6: main-path launches {launches['wkv6']}: {split}")
    return [dict(row("wkv6", launches, err, timed, bms, by, None,
                     f"{cfg.name} prefill, B=1, T={T}, H={H}, dh={dh}, "
                     "bf16"), launches_by_shape=split)]


# -- the full-width Mamba path and the SSD kernel ---------------------------

def mamba_mixers(cfg, gen) -> list:
    """The mixer half of each Mamba sublayer of one superblock: (norm
    weights, ``init_mamba`` parameters) drawn from ``gen``."""
    n = sum(m == "mamba" for m, _ in layer_kinds(cfg)[:cfg.attn_every])
    return [(norm_params(cfg.d_model, cfg.norm, gen.device),
             mamba_mod.init_mamba(gen, cfg)) for _ in range(n)]


def mixers_prefill(cfg, layers: list, x: torch.Tensor) -> tuple:
    """x [B, T, D] through each layer's norm, Mamba mixer and residual
    from a zero state: (x, the carried states)."""
    states = []
    for ln, p in layers:
        y, st = mamba_mod.mamba_forward(p, norm(x, ln, cfg.norm,
                                                cfg.norm_eps), cfg,
                                        return_state=True)
        x = x + y
        states.append(st)
    return x, states


def mixers_decode(cfg, layers: list, x: torch.Tensor, states: list):
    """One token x [B, 1, D] through every layer from ``states``, which
    take the new states."""
    for i, (ln, p) in enumerate(layers):
        y, states[i] = mamba_mod.mamba_decode(p, norm(x, ln, cfg.norm,
                                                      cfg.norm_eps),
                                              states[i], cfg)
        x = x + y
    return x


def mamba_path(seed: int) -> dict:
    """Jamba-1.5-Large's Mamba mixers at full width (d_model 8192, d_in
    16384, 256 heads of 64, d_state 16): the mixer half of the block
    (norm, ``mamba_forward`` / ``mamba_decode``, residual) for the 7
    Mamba sublayers of one superblock, bf16 weights from the seed.  The
    prefills of ``MAMBA_PREFILLS`` from a zero state, then
    ``MAMBA_DECODE`` steps from the last prefill's states; every output
    and state finite and of its shape, and no plain kernel version
    called."""
    cfg = get_arch(HYBRID_ARCH)
    m = cfg.mamba
    H = m.expand * cfg.d_model // m.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 17)
    t0 = time.perf_counter()
    layers = mamba_mixers(cfg, gen)
    torch.cuda.synchronize()
    tensors = [t for ln, p in layers for t in (*ln.values(), *p.values())]
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    say(f"Mamba path: {cfg.name}'s {len(layers)} Mamba sublayers at full "
        f"width (d_model {cfg.d_model}, d_in {m.expand * cfg.d_model}, {H} "
        f"heads of {m.head_dim}, d_state {m.d_state}, d_conv {m.d_conv}): "
        f"{n_params} parameters, {n_bytes} bytes, drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    with counting_plain() as plain_calls:
        for B, T in MAMBA_PREFILLS:
            x = torch.randn((B, T, cfg.d_model), generator=gen,
                            device=gen.device).to(torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, states = mixers_prefill(cfg, layers, x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(out.shape == x.shape and bool(torch.isfinite(
                out.float()).all()), f"Mamba path: prefill B={B}, T={T} "
                "gave a non-finite output or another shape")
            check(all(st["ssm"].shape == (B, H, m.head_dim, m.d_state) and
                      st["conv"].shape == (B, m.d_conv - 1,
                                           m.expand * cfg.d_model) and
                      bool(torch.isfinite(st["ssm"]).all())
                      for st in states), f"Mamba path: prefill B={B}, "
                  f"T={T} left a non-finite state or another shape")
            say(f"Mamba path: prefill B={B}, T={T} through {len(layers)} "
                f"layers in {secs * 1e3:.3f} ms ({B * T / secs:.1f} "
                "tokens/s)")
        B = MAMBA_PREFILLS[-1][0]
        xs = torch.randn((MAMBA_DECODE, B, 1, cfg.d_model), generator=gen,
                         device=gen.device).to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [mixers_decode(cfg, layers, x, states) for x in xs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(not any(plain_calls.values()), "Mamba path: a plain kernel "
          f"version ran on the path: {plain_calls}")
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs) and
          all(bool(torch.isfinite(st["ssm"]).all()) for st in states),
          "Mamba path: a decode step gave a non-finite output or state")
    say(f"Mamba path: {MAMBA_DECODE} decode steps at B={B} from the "
        f"carried states, {secs * 1e3 / MAMBA_DECODE:.3f} ms a step "
        f"through {len(layers)} layers ({B * MAMBA_DECODE / secs:.1f} "
        "tokens/s)")
    return {"cfg": cfg, "layers": layers, "gen": gen,
            "prefills": len(MAMBA_PREFILLS), "decode_steps": MAMBA_DECODE}


def mamba_cpu_check(mp: dict) -> None:
    """The first Mamba layer at full width on the card against the CPU's
    plain versions: its weights upcast to fp32 (exactly) on both sides,
    fp32 products in full fp32 (no TF32); a prompt of
    ``MAMBA_CPU_PROMPT`` tokens, then ``MAMBA_CPU_STEPS`` decode steps;
    every output and the final ssm state within ``FP32_LOGIT_REL_TOL``
    of its largest magnitude."""
    t0 = time.perf_counter()
    cfg = mp["cfg"]
    ln, p = mp["layers"][0]
    xs = torch.randn((1, MAMBA_CPU_PROMPT + MAMBA_CPU_STEPS, cfg.d_model),
                     generator=mp["gen"], device=mp["gen"].device)
    runs = []
    for dev in (xs.device, torch.device("cpu")):
        layers = [({k: v.to(dev) for k, v in ln.items()},
                   {k: v.float().to(dev) for k, v in p.items()})]
        x = xs.to(dev)
        out, states = mixers_prefill(cfg, layers, x[:, :MAMBA_CPU_PROMPT])
        outs = [out]
        for t in range(MAMBA_CPU_PROMPT, x.shape[1]):
            outs.append(mixers_decode(cfg, layers, x[:, t:t + 1], states))
        runs.append([o.cpu() for o in outs] + [states[0]["ssm"].cpu()])
        del layers
    torch.cuda.empty_cache()
    rel = worst_rel(*runs)
    check(all(bool(torch.isfinite(o).all()) for o in runs[0]),
          "Mamba CPU check: non-finite output on the card")
    check(rel <= FP32_LOGIT_REL_TOL, f"Mamba CPU check: the card's fp32 "
          f"layer differs from the CPU's by {rel:.6f} of the largest output "
          f"(tolerance {FP32_LOGIT_REL_TOL})")
    say(f"Mamba CPU check: one full-width layer, fp32, a prompt of "
        f"{MAMBA_CPU_PROMPT} tokens and {MAMBA_CPU_STEPS} decode steps on the "
        f"card against the CPU's plain versions: max |diff| / max |output| "
        f"= {rel:.6f} (tolerance {FP32_LOGIT_REL_TOL}); "
        f"{time.perf_counter() - t0:.3f} s")


def ssd_draw(gen, T: int, H: int, dh: int, N: int, carried: bool) -> tuple:
    """x [1, T, H, dh], B_ and C_ [1, T, N] bf16; dt fp32 in [0.001,
    0.4], A fp32 in [-1.5, -0.3] (tests/test_kernels.py's ranges) and a
    carried state fp32."""
    dev = gen.device
    x = torch.randn((1, T, H, dh), generator=gen, device=dev) \
        .to(torch.bfloat16)
    Bm, Cm = (torch.randn((1, T, N), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    dt = 0.001 + 0.399 * torch.rand((1, T, H), generator=gen, device=dev)
    A = -(0.3 + 1.2 * torch.rand((H,), generator=gen, device=dev))
    state = torch.randn((1, H, dh, N), generator=gen, device=dev) \
        if carried else None
    return x, dt, Bm, Cm, A, state


def close_fp32(name: str, got, plain, broken, variant: str) -> float:
    """fp32 outputs within 2e-5 of the largest |plain|, a limit that
    ``broken`` (a plain version without a term) must break."""
    limit = 2e-5 * float(plain.abs().max())
    err = float((got - plain).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= limit, f"{name}: "
          f"kernel differs from its plain version by {err} (limit {limit})")
    caught = int(((broken - plain).abs() > limit).sum())
    check(caught > 0, f"{name}: the limit does not see {variant}")
    say(f"{name}: within 2e-5 of the largest |plain| (max abs err "
        f"{err:.3e}, largest |plain| {float(plain.abs().max()):.6f}); "
        f"{variant} breaks the limit at {caught} of {plain.numel()} "
        "elements")
    return err


def ssd_vs_plain(mp: dict, hybrid: dict, seed: int, launches: dict,
                 split: dict) -> list:
    """ssd at Jamba's full width (H = 256, dh = 64, N = 16): a prefill
    of T = 4096 from a zero state and decode steps (T = 1) from a carried
    state in bf16 and in fp32 (the Mamba path's decode hands the kernel
    fp32), and at the hybrid's reduced decode (fp32, where 7 of every 8
    of its launches are), on inputs drawn from the seed.  bf16 outputs
    elementwise within ``ATTN_STEPS`` bf16 unit roundoffs of the plain
    version, fp32 within 2e-5 of the largest, limits that the plain
    version without the s = t term (prefill) or without the carried state
    (decode) breaks; the final state within 2e-5 of its largest
    magnitude.  No PyTorch op computes an SSD scan: no library call."""
    def widths(cfg):
        m = cfg.mamba
        return m.expand * cfg.d_model // m.head_dim, m.head_dim, m.d_state

    cfg = mp["cfg"]
    H, dh, N = widths(cfg)
    cases = ((MAMBA_PREFILLS[0][1], (H, dh, N), torch.bfloat16, False,
              f"{cfg.name} Mamba prefill"),
             (1, (H, dh, N), torch.bfloat16, True, f"{cfg.name} decode"),
             (1, (H, dh, N), torch.float32, True,
              f"{cfg.name} decode as the Mamba path runs it"),
             (1, widths(hybrid["cfg"]), torch.float32, True,
              f"{hybrid['cfg'].name} at reduced() decode"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 18)
    err = 0.0
    out = None
    for T, (H, dh, N), dtype, carried, what in cases:
        batches = []
        for _ in range(8):
            x, dt, Bm, Cm, A, state = ssd_draw(gen, T, H, dh, N, carried)
            batches.append((x.to(dtype), dt, Bm.to(dtype), Cm.to(dtype), A,
                            state))
        x, dt, Bm, Cm, A, state = batches[0]
        got, got_state = kssd.ssd(x, dt, Bm, Cm, A, state)
        torch.cuda.synchronize()
        plain, plain_state = kssd.ssd_plain(x, dt, Bm, Cm, A, state)
        if carried:
            broken, _ = kssd.ssd_plain(x, dt, Bm, Cm, A)
            variant = "the plain version without the carried state"
        else:
            # y_t less its own step's term (C_t . B_t) dt_t x_t
            diag = (Cm.float() * Bm.float()).sum(-1)
            broken = plain.float() - diag[:, :, None, None] \
                * dt[..., None] * x.float()
            variant = "the plain version without the s = t term"
        name = f"ssd (T={T}, H={H}, dh={dh}, N={N}, {str(dtype)[6:]})"
        if dtype == torch.float32:
            err = max(err, close_fp32(name, got, plain, broken, variant))
        else:
            err = max(err, close(name, got, plain, broken, variant))
        s_err = float((got_state - plain_state).abs().max())
        s_max = float(plain_state.abs().max())
        check(bool(torch.isfinite(got_state).all()) and
              s_err <= 2e-5 * s_max, f"{name}: the final state differs from "
              f"the plain version's by {s_err} (largest {s_max})")
        say(f"{name}: final state max abs err {s_err:.3e} (largest "
            f"{s_max:.3f})")
        # the plain recurrence launches some 25,000 small kernels a call
        # at T = 4096 (1.4 s): one call gives its device time
        timed = time_kernel(name, lambda *a: kssd.ssd(*a),
                            lambda *a: kssd.ssd_plain(*a), batches,
                            reps=64 if T > 1 else 640,
                            plain_reps=1 if T > 1 else 32)
        n, es = T * H * dh, x.element_size()
        # x and y, dt fp32, B_ and C_, A, the state in (when carried) and
        # out in fp32
        n_bytes = 2 * es * n + 4 * T * H + 2 * es * T * N + 4 * H \
            + 4 * H * dh * N * (2 if carried else 1)
        # the state terms: one FMA a state element for the update and one
        # for y, per token and head, at the fp32 rate
        bms, by = bound(n_bytes, 4 * dh * N * T * H)
        say(f"{name} [{what}]: bound {bms:.9f} ms ({by}, {n_bytes} bytes); "
            "library call: none, no single op computes an SSD scan")
        out = out or (timed, bms, by, T, H, dh, N)
    timed, bms, by, T, H, dh, N = out
    say(f"ssd: main-path launches {launches['ssd']}: {split}")
    return [dict(row("ssd", launches, err, timed, bms, by, None,
                     f"{cfg.name} Mamba prefill, B=1, T={T}, H={H}, "
                     f"dh={dh}, N={N}, bf16"), launches_by_shape=split)]


# -- the twelfth path: the workload matrix and the crash sweeps -----------

def traced(fn):
    """Run ``fn`` with tracing on, keeping the epoch of spans already
    recorded so that one trace holds every traced phase on one clock."""
    epoch = RECORDER.epoch if RECORDER.spans else None
    RECORDER.enable()
    if epoch is not None:
        RECORDER.epoch = epoch
    try:
        return fn()
    finally:
        RECORDER.disable()


def counts_of(done: dict) -> tuple:
    return done["found"], done["acked"], done["scanned"]


def matrix_load(session, wl, tag: str) -> None:
    """The load phase through ``run_workload`` in plans, then the first
    loaded keys read back through the kernel (the first plan re-exports
    the snapshot)."""
    t0 = time.perf_counter()
    done = run_workload(session.index, wl, phase="load", batch_lookups=True,
                        max_batch=PLAN_OPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(done["acked"] == len(wl.load_ops), f"{tag} load: an insert was "
          "not acknowledged")
    say(f"{tag} load: {rate(len(wl.load_ops), secs)}")
    read_back(session, op_keys(wl.load_ops[:PLAN_OPS]), f"{tag} load")


def matrix_run(session, wl, want, tag: str, *, buffered: bool = False,
               trace_first: bool = False) -> float:
    """The run phase through ``run_workload`` in plans of ``PLAN_OPS``
    ops (or its buffered engine): found, acked and scanned, and the
    final items, must equal ``replay``'s.  With ``trace_first`` the
    first plan's ops run traced, as a workload of their own, and the
    rest after them.  Returns the run's kops/s (host clock, ending in a
    device synchronise)."""
    index = session.index
    ops = wl.run_ops
    engine = dict(phase="run", batch_lookups=True, max_batch=PLAN_OPS,
                  buffered=buffered)
    before = read_counts()
    t0 = time.perf_counter()
    if trace_first:
        first = traced(lambda: run_workload(index, dataclasses.replace(
            wl, run_ops=ops[:PLAN_OPS]), **engine))
        rest = run_workload(index, dataclasses.replace(
            wl, run_ops=ops[PLAN_OPS:]), **engine)
        done = {k: first[k] + rest[k] for k in first}
    else:
        done = run_workload(index, wl, **engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = read_counts()
    engine = "buffered" if buffered else "plans"
    check(counts_of(done) == want.counts(), f"{tag} run ({engine}): "
          f"found/acked/scanned {counts_of(done)} differ from replay's "
          f"{want.counts()}")
    t1 = time.perf_counter()
    check(dict(index.items()) == want.model, f"{tag} run ({engine}): the "
          "final items differ from replay's model")
    ran = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    if buffered:
        shape = (f"{done['batches']} read, {done['scan_batches']} scan and "
                 f"{done['write_batches']} write flushes")
    else:
        shape = (f"{done['plans']} plans, {done['waves']} waves, "
                 f"{done['waves'] / done['plans']:.3f} waves per plan")
    say(f"{tag} run ({engine}): {rate(len(ops), secs)}; {shape}; "
        f"found {done['found']}, acked {done['acked']}, scanned "
        f"{done['scanned']}, equal to replay, and the final items equal "
        f"its model ({time.perf_counter() - t1:.3f} s to compare); "
        f"kernel launches in the run {ran}")
    return len(ops) / secs / 1e3


def timed_replay(wl, tag: str):
    t0 = time.perf_counter()
    want = replay(wl.load_ops, wl.run_ops)
    say(f"{tag} replay: {time.perf_counter() - t0:.3f} s for "
        f"{len(wl.load_ops)} + {len(wl.run_ops)} ops")
    return want


def matrix_zipf(seed: int) -> None:
    """(a) Zipf F (theta 0.99) on P-CLHT, in plans and buffered, each on
    a freshly loaded index."""
    wl = matrix_workload(seed=seed, **MATRIX_ZIPF)
    want = timed_replay(wl, "zipf F")
    rates = {}
    for buffered in (False, True):
        tag = f"P-CLHT zipf F ({'buffered' if buffered else 'plans'})"
        session = open_index("clht")
        matrix_load(session, wl, tag)
        rates[buffered] = matrix_run(session, wl, want, tag,
                                     buffered=buffered,
                                     trace_first=not buffered)
    say(f"P-CLHT zipf F run: plans {rates[False]:.3f} kops/s, buffered "
        f"{rates[True]:.3f} kops/s, plans / buffered "
        f"{rates[False] / rates[True]:.3f}x")


def matrix_sorted(kind: str, tag: str, spec: dict, seed: int) -> None:
    """(b) string-key A on P-ART, (c) skewed string-key E on P-Masstree."""
    wl = matrix_workload(seed=seed, **spec)
    want = timed_replay(wl, tag)
    session = open_index(kind)
    matrix_load(session, wl, tag)
    matrix_run(session, wl, want, tag)


def matrix_hot(seed: int) -> None:
    """(d) hot-set F on P-CLHT in 8 shards (hash routing): the run ops in
    plans of ``HOT_PLAN`` ops, round robin over ``STREAMS`` client
    streams.  Some plans defer; the summed counts equal ``replay``'s,
    and the final items equal ``replay`` of the plans in the order the
    driver admitted them (plans admitted in one tick are conflict-free,
    so their order within it does not matter).  The first tick runs
    traced."""
    tag = f"P-CLHT x{SHARDS} hot-set F"
    wl = matrix_workload(seed=seed, **MATRIX_HOT)
    want = timed_replay(wl, tag)
    session = open_index("clht", shards=SHARDS, scheme="hash")
    matrix_load(session, wl, tag)
    drv = session.streams(STREAMS, collect_results=False)
    ops = wl.run_ops
    tickets = [drv.streams[i % STREAMS].submit(Plan.from_ops(
        ops[lo:lo + HOT_PLAN]))
        for i, lo in enumerate(range(0, len(ops), HOT_PLAN))]
    t0 = time.perf_counter()
    traced(drv.tick)
    ticks = 1 + drv.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = drv.stats
    check(not drv.pending(), f"{tag}: a plan was never admitted")
    check(stats["deferred_plans"] > 0, f"{tag}: no plan deferred")
    got = (stats["found"], stats["acked"], stats["scanned"])
    check(got == want.counts(), f"{tag}: summed counts {got} differ from "
          f"replay's {want.counts()}")
    in_order = [op for t in sorted(tickets, key=lambda t: t.tick)
                for op in plan_ops(t.plan)]
    ordered = replay(wl.load_ops, in_order)
    check(ordered.counts() == want.counts(), f"{tag}: replay in admission "
          "order counts otherwise")
    check(dict(session.index.items()) == ordered.model, f"{tag}: the final "
          "items differ from replay in admission order")
    say(f"{tag}: {STREAMS} streams, {len(tickets)} plans of {HOT_PLAN} ops "
        f"in {ticks} ticks, {rate(len(ops), secs)}; deferred_plans "
        f"{stats['deferred_plans']}, multi-stream ticks "
        f"{stats['multi_stream_ticks']}; found/acked/scanned {got} equal "
        "replay's, the final items equal replay in admission order")


def keys_for(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int(k) for k in np.unique(rng.integers(1, 1 << 60, size=n))]


def sweep_ops() -> dict:
    """The reference tests' crash workloads (tests/test_indexes_common.py
    and tests/test_baselines.py of the JAX package)."""
    keys = keys_for(4, 40)
    # sequential keys force tree/leaf splits; random ones hash
    keys += list(range(0x0F00000000000000, 0x0F00000000000000 + 30))
    audit = keys_for(3, 150)
    return {
        "powerfail": [("insert", k, k ^ 0xAB) for k in dict.fromkeys(keys)]
        + [("delete", k, 0) for k in keys[:8]],
        "interrupt": [("insert", k, k + 3) for k in keys_for(5, 30)],
        "baseline": [("insert", k, k + 1) for k in keys_for(1, 50)],
        "buggy": [("insert", k, k + 1) for k in sorted(keys_for(2, 40))],
        "audit": [("insert", k, k + 9) for k in audit]
        + [("delete", k, 0) for k in audit[:40]]
        + [("lookup", k, 0) for k in audit[40:80]]
        + [("insert", k, k + 1) for k in keys_for(5, 120)],
    }


def sweep_kinds(dev) -> dict:
    """Each kind's factory on the card, as the reference tests build it,
    and the kernel its batched lookups launch."""
    return {
        "P-CLHT": (lambda pm: PCLHT(pm, n_buckets=8, device=dev),
                   "probe64_fp"),
        "P-HOT": (lambda pm: PHOT(pm, device=dev), "art_descend"),
        "P-BwTree": (lambda pm: PBwTree(pm, device=dev), "scan_window"),
        "P-ART": (lambda pm: PART(pm, device=dev), "art_descend"),
        "P-Masstree": (lambda pm: PMasstree(pm, device=dev), "scan_window"),
        "FAST&FAIR": (lambda pm: FastFair(pm, fixed=True, device=dev),
                      "scan_window"),
        "CCEH": (lambda pm: CCEH(pm, fixed=True, device=dev),
                 "scan_window"),
        "Level hashing": (lambda pm: LevelHashing(pm, device=dev), None),
        "FAST&FAIR (buggy)": (lambda pm: FastFair(pm, fixed=False,
                                                  device=dev),
                              "scan_window"),
    }


def batched_read_back(index, ops, kernel: str, tag: str) -> None:
    """Every key of the sweep's workload (and 20 absent ones) in one plan
    on the index's kernel: the answers equal the scalar lookups."""
    keys = [k for _, k, _ in ops] + [k + 1 for _, k, _ in ops[:20]]
    scalar = [index.lookup(k) for k in keys]
    before = read_counts()[kernel]
    got = index.execute(Plan.from_ops([("lookup", k, 0) for k in keys]),
                        force_kernel=True).results
    check(read_counts()[kernel] > before, f"{tag}: the read-back did not "
          f"launch {kernel}")
    check(got == scalar, f"{tag}: a batched lookup after the sweep differs "
          "from the scalar one")


def crash_sweeps(dev) -> None:
    """(e) the per-store crash sweep on the seven kinds the reference
    sweeps, the paper's FAST&FAIR bug found again, and the durability
    audit on all eight kinds, every index on ``dev`` (the card)."""
    ops = sweep_ops()
    kinds = sweep_kinds(dev)
    sweeps = [(name, mode, ops[mode], dict(post_writes=6, max_states=4000)
               if mode == "powerfail" else dict(post_writes=4,
                                                max_states=1500))
              for name in CONVERTED for mode in ("powerfail", "interrupt")]
    sweeps += [(name, "powerfail", ops["baseline"],
                dict(post_writes=4, max_states=2500))
               for name in ("FAST&FAIR", "CCEH")]
    sweeps.append(("FAST&FAIR (buggy)", "powerfail", ops["buggy"],
                   dict(post_writes=2, max_states=2500)))
    for name, mode, workload, kw in sweeps:
        make, kernel = kinds[name]
        built = []

        def factory(pm, make=make):
            built.append(make(pm))
            return built[-1]

        t0 = time.perf_counter()
        report = run_crash_sweep(factory, workload, mode=mode, **kw)
        secs = time.perf_counter() - t0
        tag = f"{name} {mode} sweep"
        check(built and built[0].device == dev, f"{tag}: the index is not "
              "on the card")
        if name == "FAST&FAIR (buggy)":
            check(not report.ok and report.consistency_failures,
                  f"{tag}: the split-persist bug was not found "
                  f"({report.summary()})")
            found = f"the bug found again: {report.consistency_failures[0]}"
        else:
            check(report.ok, f"{tag}: {report.summary()}")
            check(mode != "powerfail" or name not in CONVERTED
                  or report.n_crash_states > 50, f"{tag}: only "
                  f"{report.n_crash_states} crash states")
            found = "ok"
        batched_read_back(built[0], workload, kernel, tag)
        say(f"{tag}: {found}; n_crash_states {report.n_crash_states}, "
            f"max_stores_per_op {report.max_stores_per_op}, "
            f"{report.n_ops_tested} ops, {secs:.3f} s; the batched "
            f"read-back on {kernel} equals the scalar lookups")
    for name in ("P-CLHT", "P-HOT", "P-BwTree", "P-ART", "P-Masstree",
                 "FAST&FAIR", "CCEH", "Level hashing"):
        t0 = time.perf_counter()
        failures = audit_durability(kinds[name][0], ops["audit"])
        check(failures == [], f"{name} durability audit: {failures[:2]}")
        say(f"{name} durability audit: [] over {len(ops['audit'])} ops in "
            f"{time.perf_counter() - t0:.3f} s")


def write_matrix_trace() -> None:
    """(f) the traced plan of (a) and tick of (d), written as a Chrome
    trace and validated."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "matrix_trace.json"
        obj = obs.write_trace(str(path), RECORDER)
        errors = obs.validate_trace_file(str(path))
        size = path.stat().st_size
    check(errors == [], f"trace: {errors[:3]}")
    cats = {}
    for ev in obj["traceEvents"]:
        cats[ev["cat"]] = cats.get(ev["cat"], 0) + 1
    for cat in ("plan", "pmem", "kernel", "streams", "shard"):
        check(cats.get(cat, 0) > 0, f"trace: no {cat} event")
    say(f"trace: {len(obj['traceEvents'])} events, {size} bytes, valid; "
        f"events by cat {dict(sorted(cats.items()))}")


def matrix_path(seed: int, dev) -> None:
    RECORDER.reset()
    for phase, fn in (("(a) zipf F", lambda: matrix_zipf(seed)),
                      ("(b) string-key A", lambda: matrix_sorted(
                          "art", "P-ART string-key zipf A", MATRIX_STRING,
                          seed)),
                      ("(c) skewed scans", lambda: matrix_sorted(
                          "masstree", "P-Masstree string-key zipf E",
                          MATRIX_SCAN, seed)),
                      ("(d) hot set", lambda: matrix_hot(seed)),
                      ("(e) crash sweeps", lambda: crash_sweeps(dev)),
                      ("(f) trace", write_matrix_trace)):
        t0 = time.perf_counter()
        fn()
        say(f"matrix path {phase}: {time.perf_counter() - t0:.3f} s")
    RECORDER.reset()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-clht", type=int, default=1 << 20)
    # P-ART's load is the longest of the index paths (some 14 kops/s):
    # 2^19 keys keep the whole run within two thirds of its time limit
    ap.add_argument("--n-art", type=int, default=1 << 19)
    ap.add_argument("--n-hot", type=int, default=1 << 18)
    ap.add_argument("--n-masstree", type=int, default=1 << 18)
    ap.add_argument("--n-bwtree", type=int, default=1 << 15)
    # one CCEH directory and one Level hashing level must each fit an
    # arena segment (65,528 words): a 2^16-key CCEH load and a
    # 20,480-key Level hashing load overflow it
    ap.add_argument("--n-cceh", type=int, default=1 << 15)
    ap.add_argument("--n-fastfair", type=int, default=1 << 16)
    ap.add_argument("--n-level", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    check(torch.cuda.is_available(), "no CUDA device")
    # fp32 products in full fp32 (PyTorch's default), for the fp32 check
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build()
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.3f} s")
    check(set(built) >= {"probe", "art_descend", "scan_window",
                         "shard_route", "conflict_any", "flash_attention",
                         "paged_attention", "clht_probe", "wkv6", "ssd"},
          "a kernel source was not built")
    logs = "".join(b.log for b in built.values())
    for name in ("partition_cluster_kernel", "partition_count_kernel",
                 "partition_scan_kernel", "partition_scatter_kernel",
                 "tag_probe_kernel", "clht_probe_kernel"):
        check(name in logs, f"{name} is not in the build's kernels")
    for name, b in built.items():
        for line in ptxas_lines(b.log):
            say(f"  {name}: {line}")

    paths = [
        ("P-CLHT", "clht", ("probe64_fp", "probe64"),
         lambda s: point_path(s, args.n_clht, args.seed, "P-CLHT",
                              edge_keys=False)),
        ("P-ART", "art", ("art_descend", "art_pack_entries"),
         lambda s: point_path(s, args.n_art, args.seed, "P-ART",
                              edge_keys=True)),
        ("P-HOT", "hot", ("art_descend", "art_pack_entries"),
         lambda s: point_path(s, args.n_hot, args.seed, "P-HOT",
                              edge_keys=True)),
        ("P-Masstree", "masstree", ("scan_window",),
         lambda s: sorted_path(s, args.n_masstree, args.seed, "P-Masstree",
                               n_e0=4 * PLAN_OPS, n_e=2 * PLAN_OPS)),
        ("P-BwTree", "bwtree", ("scan_window",),
         lambda s: sorted_path(s, args.n_bwtree, args.seed, "P-BwTree",
                               n_e0=2 * PLAN_OPS, n_e=0)),
    ]
    sessions = {}
    launches = {name: 0 for name in SOURCES}
    # the scans' launches by shape: prefills (T > 1) and decode steps
    split = {"wkv6": {"prefill": 0, "decode": 0},
             "ssd": {"prefill": 0, "decode": 0}}
    for tag, kind, kernels, drive in paths:
        session = sessions[tag] = open_index(kind)
        check(session.device.type == "cuda", f"the {tag} session is not on "
              "the card")
        reset_counts()
        t0 = time.perf_counter()
        drive(session)
        counts = read_counts()
        say(f"{tag} path: {time.perf_counter() - t0:.3f} s; kernel launches "
            f"{counts}")
        for name in kernels:
            check(counts[name] > 0, f"{name} was not launched on the {tag} "
                  "path")
        for name, done in counts.items():
            launches[name] = launches.get(name, 0) + done

    reset_counts()
    t0 = time.perf_counter()
    scale = scale_out_path(sessions, args)
    counts = read_counts()
    say(f"scale-out path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    for name in ("shard_partition", "conflict_any", "scan_window_sharded",
                 "probe64_fp", "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the scale-out "
              "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done

    reset_counts()
    t0 = time.perf_counter()
    serve = serving_path(SERVE_ARCH, args.seed)
    counts = read_counts()
    check(serve["lm"].device.type == "cuda", "the serving path's model is "
          "not on the card")
    say(f"serving path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{counts}")
    for name in ("flash_attention", "paged_attention", "probe64_fp",
                 "art_descend", "art_pack_entries", "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the serving "
              "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    serving_cpu_check(serve, min(serve["prompts"], key=len))
    decode_busy(serve)

    reset_counts()
    t0 = time.perf_counter()
    rwkv = serving_path(RWKV_ARCH, args.seed, RWKV_EXTRA_PROMPTS)
    counts = read_counts()
    check(rwkv["lm"].device.type == "cuda", "the RWKV serving path's model "
          "is not on the card")
    say(f"RWKV serving path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    n_layers = rwkv["cfg"].n_layers
    want = n_layers * (rwkv["prefills"] + rwkv["decode_steps"])
    check(counts["wkv6"] == want, f"wkv6 was launched {counts['wkv6']} "
          f"times on the RWKV serving path, not {n_layers} per prefill "
          f"({rwkv['prefills']}) and per decode step "
          f"({rwkv['decode_steps']}): {want}")
    split["wkv6"]["prefill"] += n_layers * rwkv["prefills"]
    split["wkv6"]["decode"] += n_layers * rwkv["decode_steps"]
    for name in ("probe64_fp", "art_descend", "art_pack_entries",
                 "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the RWKV "
              "serving path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    # a full-width CPU run of a 512-token prompt is slow: the check takes
    # the path's 32-token prompt (the width is not cut)
    serving_cpu_check(rwkv, min(rwkv["prompts"], key=len))
    decode_busy(rwkv)

    reset_counts()
    t0 = time.perf_counter()
    mamba = mamba_path(args.seed)
    counts = read_counts()
    say(f"Mamba path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{counts}")
    n_mixers = len(mamba["layers"])
    want = n_mixers * (mamba["prefills"] + mamba["decode_steps"])
    check(counts["ssd"] == want, f"ssd was launched {counts['ssd']} times "
          f"on the Mamba path, not {n_mixers} per prefill "
          f"({mamba['prefills']}) and per decode step "
          f"({mamba['decode_steps']}): {want}")
    split["ssd"]["prefill"] += n_mixers * mamba["prefills"]
    split["ssd"]["decode"] += n_mixers * mamba["decode_steps"]
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    mamba_cpu_check(mamba)

    reset_counts()
    t0 = time.perf_counter()
    hybrid = serving_path(HYBRID_ARCH, args.seed, HYBRID_EXTRA_PROMPTS,
                          reduced=True)
    counts = read_counts()
    check(hybrid["lm"].device.type == "cuda", "the hybrid serving path's "
          "model is not on the card")
    say(f"hybrid serving path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    kinds = layer_kinds(hybrid["cfg"])
    n_mixers = sum(mixer == "mamba" for mixer, _ in kinds)
    want = n_mixers * (hybrid["prefills"] + hybrid["decode_steps"])
    check(counts["ssd"] == want, f"ssd was launched {counts['ssd']} times "
          f"on the hybrid serving path, not {n_mixers} per prefill "
          f"({hybrid['prefills']}) and per decode step "
          f"({hybrid['decode_steps']}): {want}")
    split["ssd"]["prefill"] += n_mixers * hybrid["prefills"]
    split["ssd"]["decode"] += n_mixers * hybrid["decode_steps"]
    for name in ("flash_attention", "paged_attention", "probe64_fp",
                 "art_descend", "art_pack_entries", "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the hybrid "
              "serving path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    # the reduced model is small: the check takes the longest prompt
    serving_cpu_check(hybrid, max(hybrid["prompts"], key=len))
    decode_busy(hybrid)

    reset_counts()
    t0 = time.perf_counter()
    tag = tag_path(args.seed)
    counts = read_counts()
    say(f"tag path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{counts}")
    check(counts["tag_probe"] > 0, "tag_probe was not launched on the tag "
          "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    tag_wave_ops(tag)

    reset_counts()
    t0 = time.perf_counter()
    matrix_path(args.seed, torch.device("cuda", 0))
    counts = read_counts()
    say(f"matrix path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{counts}")
    for name in ("probe64_fp", "art_descend", "art_pack_entries",
                 "scan_window", "shard_partition", "conflict_any"):
        check(counts[name] > 0, f"{name} was not launched on the matrix "
              "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done

    say(f"paths done: {time.perf_counter() - t_start:.3f} s")
    rows = []
    for check_rows, fargs in (
            (probe_vs_plain, (sessions["P-CLHT"].index, args.seed,
                              launches)),
            (radix_vs_plain, ([("P-ART", sessions["P-ART"]),
                               ("P-HOT", sessions["P-HOT"])], args.seed,
                              launches)),
            (scan_vs_plain, (sessions["P-Masstree"], args.seed, launches)),
            (sharded_scan_vs_plain, (scale, args.seed, launches)),
            (route_vs_plain, (scale, launches)),
            (conflict_vs_plain, (scale, launches)),
            (paged_vs_plain, (serve, args.seed, launches)),
            (flash_vs_plain, (serve, args.seed, launches)),
            (clht_vs_plain, (tag, launches)),
            (wkv6_vs_plain, (rwkv, args.seed, launches, split["wkv6"])),
            (ssd_vs_plain, (mamba, hybrid, args.seed, launches,
                            split["ssd"]))):
        t0 = time.perf_counter()
        rows += check_rows(*fargs)
        say(f"{check_rows.__name__}: {time.perf_counter() - t0:.3f} s")
    check([r["name"] for r in rows] == list(SOURCES), "a kernel is missing "
          "from the kernels line")
    say(f"whole run: {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
