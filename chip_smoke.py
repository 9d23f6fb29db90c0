#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--n-clht 262144] [--n-art 131072]
                          [--n-hot 131072] [--n-masstree 65536]
                          [--n-bwtree 16384] [--n-cceh 16384]
                          [--n-fastfair 32768] [--n-level 16384]
                          [--seed 0]

(the defaults shown).

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
CPU with the plain versions and the same weights, bf16 on both sides.
Every serving path runs through one function (``serving_run``) and its
CPU check through another (``serving_cpu_check``), which frees the
path's model.

The eighth, the RWKV serving path, runs the same workload, cut to 8
requests as the MoE paths run it, on RWKV6-7B at full width (32
layers, d_model 4096, 64 heads of 64, d_ff 14336, vocabulary 65,536,
bf16 from ``--seed``), plus prompts of exactly 32 and 64 tokens (its
layer and head counts) in the last phase: time mixing on
the WKV6 kernel (``csrc/wkv6.cu``), 32 launches per prefill and per
decode step, the index kernels as above, no plain version on the path.
Its CPU check takes the 32-token prompt, in fp32 on both sides.

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
in fp32 on both sides, and compares the MoE layers' expert sets as the
MoE paths' checks do.

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
  P-CLHT, 2^17 keys loaded and 2^15 run ops through ``run_workload`` in
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

The thirteenth to fifteenth, the MoE and sliding-window serving paths,
run the serving workload (8 requests, crash and recovery, blocking then
pipelined) on DeepSeek-MoE-16B at full width (28 layers, d_model 2048,
16 heads, a dense layer 0, then 64 routed experts top-6 of width 1408
and 2 shared experts; 16.3 B parameters, 32.6 GB bf16), on
StarCoder2-15B at full width (40 layers, d_model 6144, 48 heads over 4
KV heads, LayerNorm, GELU MLP of 24576, a sliding window of 4096; 16.0
B parameters, 31.9 GB) plus one prompt of 4352 tokens, 256 past the
window, whose prefill and decode mask real keys on both attention
kernels (``paged_attention`` with a window, counted again as
``paged_attention windowed``), and on Mixtral-8x22B at full width cut
to its first 4 of 56 layers (d_model 6144, 48 heads over 8 KV heads,
8 experts of 16384 top-2, a window of 4096; 10.1 B parameters, 20.3 GB;
281 GB in bf16 at full depth) plus prompts of 4096 and 4352 tokens, at
and past its window.  No plain version runs on them.  Each path's CPU
check runs fp32 on both sides, at full width and cut depth with the
served weights (DeepSeek: dense0 and two MoE layers over the shortest
prompt; StarCoder2 and Mixtral: two layers over the 4352-token prompt),
holds every token's top-K expert set on the card to the CPU's (a
differing set fails unless it is a printed router near-tie, and a run
with a near-tie sends the check to the path's next prompt: one prompt
must run with every set equal), and frees the model before the next
path draws.

The sixteenth, the training path, runs ``repro_torch.launch.train``:

* (a) MiniCPM-2B at full width (40 layers, d_model 2304, 36 heads of 64,
  an untied head over 122,753 words; 3,007,701,504 parameters, 48.1 GB
  of training state: bf16 weights and gradients, fp32 AdamW moments and
  master copy) for 4 steps of B = 8, T = 64 under WSD, the JAX defaults
  (fewer steps than ``ckpt_every``: the checkpoint store holds no leaf
  over 65,528 words), under ``train``'s ``remat="full"`` (each layer's
  forward recomputed in the backward, as the JAX package's default):
  every loss finite, the launches exactly 80 ``flash_attention`` (40
  forward, 40 recomputed) and 40 ``flash_attention_bwd`` a step (the
  backward kernel of ``csrc/flash_attention_bwd.cu``, behind ``mha``'s
  autograd), no plain version, peak card memory under 70 GB, ms a step
  after the first and one step's device busy share;
* (b) the same weights cut to 2 of 40 layers, in fp32, on the card and
  the CPU over one batch of B = 2, T = 64: the loss within 1e-5 and each
  leaf's gradient within 1e-4 of its largest magnitude;
* (c) the crash and restart example's run on the card (MiniCPM-2B at
  ``reduced()``, 200 steps, a checkpoint every 25, a power failure at
  step 110): it ends at step 200 (cursor and generation too), the loss
  falls, generation 200 restores the live parameters bit for bit;
* between (b) and (c), one step of (a)'s shape under each remat policy
  (``full``, ``dots``, ``none``): its peak card memory less what was
  held before its model was drawn, beside the dry run's argument plus
  temp bytes for that step, the launches of each policy exact.

Every training path states its model's remat policy; under ``"full"``
each layer's forward kernel launches twice a step (the forward and its
recompute) and its backward kernel once.

The seventeenth, the recurrent training path, trains the families whose
mixers are scans, through the scans' backward kernels
(``csrc/wkv6_bwd.cu``, ``csrc/ssd_bwd.cu``, behind the autograd of
``wkv6_heads`` and ``ssd_heads``):

* (a) RWKV6-7B at full width (d_model 4096, 64 heads of 64, d_ff
  14336, vocabulary 65,536) cut to 8 of its 32 layers as the Mixtral
  serving path cuts depth (2,282,033,152 parameters, 36.5 GB of
  training state; 120.3 GB at full depth): 4 steps of
  ``make_train_step`` on the token pipeline's batches of B = 8, T = 256,
  as the JAX package's train loop runs a step: every loss finite,
  exactly 16 ``wkv6`` and 8 ``wkv6_bwd`` launches a step, no plain
  version, peak card memory under 70 GB, ms a step after the first and
  one step's device busy share;
* (b) the trained weights cut to 2 of 32 layers, in fp32, on the card
  and the CPU over one batch of B = 2, T = 72: the loss within 1e-5 and
  each leaf's gradient within 1e-4 of its largest magnitude;
* (c) the hybrid (Jamba-1.5-Large at ``reduced()``: one full-width
  superblock is 90.3 GB in bf16) through ``train``, 4 steps of B = 8,
  T = 64: exactly 14 ``ssd``, 7 ``ssd_bwd``, 2 ``flash_attention`` and
  one ``flash_attention_bwd`` launch a step, no plain version, then the
  same fp32 check over every layer.

The eighteenth and nineteenth paths run the encoder-decoder and VLM
families at model level, as the JAX package runs them (its ``Server``
and ``train()`` feed tokens only, and the port's refuse them), each
phase's launches counted exactly and no plain version on either:

* Whisper-tiny at full width and depth (4 encoder and 4 decoder layers,
  d_model 384, 6 heads of 64, vocabulary 51,865, 1500 frames drawn from
  ``--seed``; 56,364,288 parameters): 4 requests of 32-64 tokens, each
  prefilled with its frames through ``make_prefill_step`` (12
  ``flash_attention`` a prefill: 4 encoder layers not causal, 4 causal
  self-attention, 4 cross attention not causal), the encoder's output
  from ``_encode`` (4), 32 greedy decode steps of the 4 together
  through ``make_decode_step(with_enc=True)`` (4 ``paged_attention``
  and 4 ``flash_attention`` a step: T = 1 against 1500 rows); its fp32
  check over the shortest prompt and 4 decode steps; then 4
  ``make_train_step`` steps of B = 8, T = 64 (20 ``flash_attention``:
  the encoder's 4 once, the decoder's 8 self and cross twice; 12
  ``flash_attention_bwd`` a step) and their fp32 check at B = 2;
* InternVL2-76B at full width cut to 8 of its 80 layers (d_model 8192,
  64 heads over 8 KV heads of 128, 1025 patches of width 3200 drawn
  from ``--seed``; 8,972,804,096 parameters, 17.95 GB bf16): 2 requests
  of 1025 patches and 96 and 128 text tokens, each prefilled (8
  ``flash_attention``), then 16 greedy decode steps of the 2 together
  (8 ``paged_attention`` a step); its fp32 check at 1 of the 8 layers
  over the shorter prompt and 4 decode steps, the served model freed
  first; then the model at full width cut to 1 layer (2,983,223,296
  parameters) through 4 ``make_train_step`` steps of B = 4, T = 64
  text tokens after the 1025 patches (2 ``flash_attention`` and 1
  ``flash_attention_bwd`` a step), its peak card memory under
  ``TRAIN_PEAK_GB``, and their fp32 check at B = 1.

Each prints its prefills' tokens/s and a decode step's ms on the host
clock and on the card (the last prefill and step profiled), and the
train steps' ms and busy share.

The twentieth, the decode cell path, runs the dry run's ``decode_32k``
cell of Qwen2-0.5B at full width and all 24 layers (B = 128 against
32,768 slots of cache, ``make_decode_step`` at pos = 32,767, so every
page is read): first with the ``kv_int8`` cache (25.77 GB of random
int8; the paged kernel reads the int8 pages and dequantizes in
registers), then with the bf16 cache (51.54 GB), the caches freed in
between.  For each: the dry run's count of the same cell on ``meta``
(``launch.steps.lower_cell``, ``analysis.roofline.count_costs``) and its
bound on the H100's spec sheet; 4 steps counted, exactly 24 launches of
the variant's form a step (``paged_attention int8`` or
``paged_attention``), no other kernel and no plain version, logits
finite; host ms a step, device ms a step (one step queued behind a
sleep), the profiler's busy time, the busy share and peak card memory;
the run fails if a device reading is below the bound.  Then one int8
decode step at B = 2 over 256 slots with the weights upcast to fp32 on
the card and the CPU, logits within ``FP32_TOL`` of the largest.

The twenty-first, the 32 x 8 share, runs one H100's share of
CodeQwen1.5-7B on the production mesh (``launch.mesh.
make_production_mesh``: 32 x 8, as the JAX dry run's 16 x 16), where
every rule divides at model = 8: rank 0 of a ``fake`` process group of
256 (``launch.mesh.device_mesh``), its shards of the full width and all
32 layers drawn on the card from ``--seed`` (4 of the 32 heads and kv
heads of 128, 1,680 of the 13,440 FFN columns, 11,552 of the 92,416
words), nothing whole made.  The share is first counted on ``meta``
(argument and temp bytes, which must fit the card, per-device terms,
collective MB by kind and axis, the bound), then run on the card
through ``lower_cell`` under the fake group (its collectives move
nothing): ``decode_32k`` (4 of the 128 sequences against 32,768 slots
at pos = 32,767, every page read) and ``prefill_32k`` (1 of the 32
sequences of 32,768 tokens), 3 steps each, exactly 32 launches of
``paged_attention`` or ``flash_attention`` a step, the local logits
finite; and ``train_4k`` (8 of the 256 sequences of 4,096 tokens: the
forward, the backward under ``remat="full"`` and the ZeRO AdamW step),
2 steps, exactly 64 ``flash_attention`` (32 forward, 32 recomputed) and
32 ``flash_attention_bwd`` a step, the first step's loss finite; all at
H = Hk = 4, dh = 128; then ``decode_32k`` under the ``kv_seqshard``
variant (the cache's slots over "model": rank 0 holds 4 sequences'
first 4,096 slots of all 32 kv heads, q's 32 heads gathered; every
pos at 32,767, on the last "model" rank's shard, so rank 0's slots
are all live and it writes nothing), 3 steps and one more at pos =
2,047 (rank 0 writes that slot of each sequence and nothing else),
exactly 32 ``paged_attention`` a step, each device's slots attended
by the kernel with its log-sum-exp and the shards merged by it; no
other kernel and no plain version; device ms (events) and profiler
busy ms a step, neither below the share's compute and memory bound,
the collective term printed beside them as what the deployment would
add, and the card's peak memory less what was held before the share
beside the count's argument plus temp bytes.  Rows 8, 9 and 9b gain
those shapes under ``other_shapes`` (phase 4); row 8 also its form
with the log-sum-exp at the slot-sharded shape (B = 4, H = Hk = 32,
4,096 slots), with the library call that returns its log-sum-exp too,
the edges a slot shard meets and 8 shards merged against the
unsharded kernel, and the log-sum-exp's store timed at the base
share's shape.

Phases, each of which exits non-zero on failure:

1. card check: a CUDA device, its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled in parallel; each
   kernel's registers, shared memory and spills as ``-Xptxas -v`` gives
   them;
3. the twenty-one paths, each with every kernel's launch count set to 0 just
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
   roundoffs, a limit that a dropped newest key breaks, and with
   StarCoder2's window (decode at lengths 4353-4384 and the prefill at
   T = 4352), a limit the window's absence breaks; the tag probe's
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
   within the same limit in bf16 and ``FP32_TOL`` (2e-5) of the largest
   magnitude in fp32, which the plain version without the s = t term or
   without the carried state breaks; the attention backward kernel at
   MiniCPM-2B's training shape, Qwen2-0.5B's heads at T = 512,
   StarCoder2-15B's heads with a window of 512 over T = 1100 and the
   hybrid's reduced() training shape, in fp32 and bf16, dq, dk
   and dv within the same limit, which the plain version without the D
   term breaks, two calls bit-identical, and the forward's log-sum-exp
   (its input) within ``LSE_TOL`` of the plain version's, +inf on the
   same rows; the forward at T = 512 timed with and without its
   log-sum-exp; the forward at Whisper-tiny's encoder (T = S = 1500) and
   cross attention (64, a prefill's 43 and a decode step's 1 query
   against 1500 rows), not causal, which the plain version with a
   causal mask breaks (at one query, the plain version without the last
   28 keys), and at InternVL2-76B's prefill (T = 1153, 64 heads over 8
   of 128), causal; the backward at Whisper-tiny's training batch, not
   causal (its encoder and its cross attention), and at InternVL2-76B's
   full-width training batch (T = 1089, causal); the paged kernel at
   Whisper-tiny's and InternVL2-76B's decode shapes, and its int8 form at
   the decode_32k cell's shape (B = 128, 2,048 pages a sequence) within
   the same limit, which the plain version at a scale of 1/16 breaks,
   timed beside the bf16 pages' kernel at the same shape; the scans' backward
   kernels at RWKV6-7B's training shape
   (B = 8, T = 256, H = 64, dh = 64) and Jamba's full-width mixer shape
   (B = 1, T = 4096, H = 256, dh = 64, N = 16), in bf16 and fp32, and at
   a ragged T with a carried state, the final state's gradient and
   strong decays, at T = 1, at T = 63, 65 and 129 from a carried state
   (the chunked form's edges), and (SSD) at the hybrid's reduced()
   training and fp32-check shapes: bf16 gradients within the same
   limit, fp32 ones within ``FP32_TOL`` of their largest magnitude (each
   output's share of its limit printed), which the plain version with
   the first and last steps' output gradient dropped (and without the
   final state's gradient) breaks on every output, two calls
   bit-identical, and in bf16 at the main path's shapes the call that
   takes the forward's chunk states (as the autograd ops make it)
   bit-identical to the one that recomputes them;
   then per-launch times at the main path's shape (device time from
   CUDA events around ``PROFILED_REPS`` calls queued behind a sleep
   kernel, the profiler's reading over as many calls printed beside it;
   call time from CUDA events around back-to-back calls), beside the
   plain version's (one warm call, then one queued call, marked
   ``plain_host_inclusive`` where host time is in it), a
   library call's where one computes the same function, and the least
   time the card could take (``bound_ms``); each phase's seconds.

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
import gc
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
from repro_torch.models.model import REMAT_POLICIES  # noqa: E402
from repro_torch.models import ffn as ffn_mod  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models.attention import KV_QSCALE  # noqa: E402
from repro_torch.models.common import norm, norm_params  # noqa: E402
from repro_torch.obs import RECORDER  # noqa: E402
from repro_torch.serving import Server  # noqa: E402
from repro_torch.serving.engine import _pad_caches  # noqa: E402
from repro_torch.convert import (lm_arrays_from_params,  # noqa: E402
                                 lm_params_from_arrays)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCfg  # noqa: E402
from repro_torch.launch.mesh import (device_mesh,  # noqa: E402
                                     make_production_mesh, make_smoke_mesh)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    flash_bwd_work, flash_work, paged_work, seen_pairs, ssd_bwd_work,
    ssd_work, wkv6_bwd_work, wkv6_work)

PLAN_OPS = 4096
Q = 4096  # queries per launch on the main path (one full read wave)
SLOTS = 3
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern
# NVIDIA H100 SXM data sheet (repro_torch.analysis.roofline, their one
# home): HBM3 bandwidth, the float32 rate outside the tensor cores
# standing in for 32-bit integer lanes, and the dense bf16 tensor-core
# rate
HBM_BYTES_PER_S = roofline.HBM_BW
LANE_OPS_PER_S = roofline.LANE_OPS
# calls a kernel's device time is taken over, and profiled over (its
# back-to-back calls are more)
PROFILED_REPS = 32
# what the profiler records: the card's kernels, copies and fills, the
# only events any reading here takes (host events multiply the trace's
# size and the time to read it)
CARD_ACTIVITY = [torch.profiler.ProfilerActivity.CUDA]
BF16_FLOPS_PER_S = roofline.PEAK_FLOPS
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
           "paged_attention int8": "src/repro_torch/csrc/paged_attention.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/csrc/flash_attention_bwd.cu",
           "clht_probe": "src/repro_torch/csrc/clht_probe.cu",
           "tag_probe": "src/repro_torch/csrc/clht_probe.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu",
           "wkv6_bwd": "src/repro_torch/csrc/wkv6_bwd.cu",
           "ssd": "src/repro_torch/csrc/ssd.cu",
           "ssd_bwd": "src/repro_torch/csrc/ssd_bwd.cu"}
# the sharded search is scan_window with a shard axis; on the JAX
# package's mesh path it takes the place of a vmapped lower bound
# (src/repro/distributed/mesh.py:84), which is not a Pallas kernel; the
# per-epoch packing of the descent's child entries takes the place of the
# JAX package's upload of `level` and `is_leaf` beside the child table
# (its _prepare), which is not one either; the partition takes the place
# of the routing kernel and the host's stable sort by shard
# (src/repro/kernels/partition/ref.py:75, partition_ref), and the tag
# probe that of the window kernel and the gather that feeds it
# (src/repro/kernels/clht_probe/ops.py:147); the attention backward
# replaces no TPU kernel: it is the gradient of _sdpa that
# jax.value_and_grad takes in the JAX package's train step; nor do the
# scans' backward kernels: each is the gradient of the jnp chunked form
# (_wkv_chunked, _ssd_chunked) that the same call differentiates
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
            "paged_attention int8":
                "src/repro/kernels/paged_attention/kernel.py:68",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:90",
            "flash_attention_bwd": "src/repro/launch/steps.py:34",
            "clht_probe": "src/repro/kernels/clht_probe/kernel.py:38",
            "tag_probe": "src/repro/kernels/clht_probe/kernel.py:38",
            "wkv6": "src/repro/kernels/rwkv6_scan/kernel.py:60",
            "wkv6_bwd": "src/repro/models/rwkv.py:57",
            "ssd": "src/repro/kernels/mamba_scan/kernel.py:58",
            "ssd_bwd": "src/repro/models/mamba.py:57"}
# the paged attention's launches that took a sliding window (the JAX
# package masks the window outside its kernel,
# src/repro/models/attention.py:169), counted among its launches and
# again under this name
WINDOWED_COUNT = "paged_attention windowed"
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
# RWKV6-7B's layer count (32) and head count (64): prompts of these
# lengths broke the reference's cache padding (ROADMAP Queue 3, item 6)
RWKV_EXTRA_PROMPTS = (32, 64)
# the MoE family and sliding windows, 8 requests each at full width
# (every full-width decode step reads every routed expert under GShard's
# dispatch): DeepSeek-MoE-16B (a dense layer 0, 64 routed experts top-6
# and 2 shared; 32.6 GB in bf16), StarCoder2-15B (window 4096; 31.9 GB)
# and Mixtral-8x22B (8 experts top-2, window 4096; 281 GB in bf16 at its
# 56 layers) cut to its first 4 layers, 20.3 GB.  StarCoder2's extra
# prompt runs 256 tokens past its window, and Mixtral's end at and 256
# past it, so both windowed kernels mask real keys; they take a cache of
# that length.  Each CPU check runs fp32 on both sides at full width and
# cut depth (DeepSeek: dense0 and two MoE layers over its shortest
# prompt; StarCoder2 and Mixtral: two layers over the prompt past the
# window)
MOE_ARCH = "deepseek-moe-16b"
CODER_ARCH = "starcoder2-15b"
MIXTRAL_ARCH = "mixtral-8x22b"
CODER_LONG = 4096 + 256
CODER_MAX_LEN = CODER_LONG + SERVE_NEW + 2
WIDE = dict(requests=8)
WIDE_PATHS = {
    MOE_ARCH: dict(WIDE, cpu_layers=3),
    CODER_ARCH: dict(WIDE, extra=(CODER_LONG,), max_len=CODER_MAX_LEN,
                     pick=max, cpu_layers=2),
    MIXTRAL_ARCH: dict(WIDE, extra=(4096, CODER_LONG), depth=4,
                       max_len=CODER_MAX_LEN, pick=max, cpu_layers=2)}
# decode steps a busy share is measured over: the profiler's bookkeeping
# of a step's 500-3,600 kernels takes seconds a step
BUSY_STEPS = 4
# a card/CPU difference in a token's top-K expert set is a router
# near-tie, printed and not gated, only where the CPU's K-th and
# (K+1)-th router probabilities lie within this of each other; the check
# then runs the path's next prompt, up to TIE_PROMPTS of them
ROUTER_TIE = 1e-6
TIE_PROMPTS = 2
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
                  (kflash.kernel, "attention_bwd_plain"),
                  (kpaged.kernel, "paged_attention_plain"),
                  (kwkv.kernel, "wkv6_plain"),
                  (kwkv.kernel, "wkv6_bwd_plain"),
                  (kssd.kernel, "ssd_plain"),
                  (kssd.kernel, "ssd_bwd_plain"))
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
MATRIX_ZIPF = dict(mix="F", n_load=1 << 17, n_run=1 << 15, dist="zipfian",
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
# an fp32 kernel against its plain version (the same fp32 arithmetic in
# another order): every output, and every carried state, within FP32_TOL
# of its largest magnitude
FP32_TOL = 2e-5
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
# the training path: MiniCPM-2B at full width (40 layers, d_model 2304,
# 36 heads of 64, vocabulary 122,753; 3,007,703,808 parameter values, the
# config's analytic 3,007,701,504 plus the final norm's 2,304 it leaves
# out; 48.1 GB of training state at 16 bytes a parameter) for the JAX defaults' 4 steps
# of B = 8, T = 64 (fewer than ckpt_every: the checkpoint store holds no
# leaf over 65,528 words); the same weights cut to 2 layers in fp32 on
# the card and the CPU over one batch of B = 2, T = 64; then the crash
# and restart example's run at reduced(): 200 steps, a checkpoint every
# 25, a power failure at step 110
TRAIN_ARCH = "minicpm-2b"
TRAIN_STEPS = 4
TRAIN_BATCH = 8
TRAIN_SEQ = 64
TRAIN_PARAMS = 3_007_703_808
TRAIN_PEAK_GB = 70.0
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = 2
TRAIN_LOSS_TOL = 1e-5  # relative, fp32 on both sides
TRAIN_GRAD_TOL = 1e-4  # of each leaf's largest |g|, fp32 on both sides
CRASH_RUN = dict(steps=200, batch=8, seq_len=64, ckpt_every=25,
                 kill_at_step=110)
# the recurrent training path: RWKV6-7B at full width (d_model 4096, 64
# heads of 64, d_ff 14336, vocabulary 65,536) cut to 8 of its 32 layers
# as the Mixtral serving path cuts depth: 2,282,033,152 parameter values
# (the config's param_count says 2,282,094,592: it counts (2L - 1) d more
# than the model holds), 36.5 GB of training state at 16 bytes a
# parameter (120.3 GB at full depth, more than the card); 4 steps of B =
# 8, T = 256 (four of the forward's 64-step chunks); its fp32 check cuts
# the trained weights to 2 layers over one batch of B = 2, T = 72 (ragged
# over the backward's 16-step chunks).  The hybrid trains at reduced()
# (one full-width superblock is 90.3 GB in bf16): 4 steps of B = 8,
# T = 64 through ``train``, its fp32 check over every layer.
RECUR_ARCH = "rwkv6-7b"
RECUR_LAYERS = 8
RECUR_PARAMS = 2_282_033_152
RECUR_STEPS = 4
RECUR_BATCH = 8
RECUR_SEQ = 256
RECUR_PEAK_GB = 70.0
RECUR_CHECK_LAYERS = 2
RECUR_CHECK_BATCH = 2
RECUR_CHECK_SEQ = 72
HYBRID_TRAIN = dict(steps=4, batch=8, seq_len=64, ckpt_every=10)
# the encoder-decoder path: Whisper-tiny at full width and depth (4
# encoder and 4 decoder layers, d_model 384, 6 heads of 64, GELU MLP of
# 1536, LayerNorm, vocabulary 51,865, 1500 frames; 56,364,288 parameter
# values, 0.11 GB bf16) at model level, as the JAX package runs it (its
# Server and train() feed tokens only): 4 requests of 32-64 tokens, each
# prefilled with its 1500 frames (drawn from --seed: the conv front end
# is a stub), the encoder's output from ``_encode``, 32 greedy decode
# steps of the 4 together through ``make_decode_step(with_enc=True)``;
# then 4 ``make_train_step`` steps of B = 8, T = 64; each fp32 check over
# the whole model (prefill and 4 decode steps over the shortest prompt;
# the loss and gradients at B = 2)
WHISPER_ARCH = "whisper-tiny"
WHISPER_PARAMS = 56_364_288
WHISPER_PROMPTS = (32, 43, 54, 64)
WHISPER_DECODE = 32
WHISPER_TRAIN = dict(steps=4, batch=8, seq=64)
WHISPER_CHECK_BATCH = 2
# the VLM path: InternVL2-76B at full width (d_model 8192, 64 heads over
# 8 KV heads of 128, SwiGLU MLP of 28672, vocabulary 128,256, a projector
# from 1025 patch embeddings of width 3200) cut to 8 of its 80 layers as
# the Mixtral path cuts depth: 8,972,804,096 parameter values, 17.95 GB
# bf16 (141 GB at full depth): 2 requests of 1025 patches (drawn from
# --seed: the InternViT front end is a stub) and 96 and 128 text tokens,
# each prefilled over 1121 and 1153 positions, then 16 greedy decode
# steps of the 2 together; its fp32 check at 1 of the 8 layers over the
# shorter prompt and 4 decode steps.  Training runs at full width cut to
# 1 layer (2,983,223,296 parameter values: 47.7 GB at AdamW's 16 bytes
# a parameter, the bf16 weight and gradient, two moments and an fp32
# master): 4 steps of B = 4, T = 64 text tokens after the 1025 patches
# (1089 positions), its peak under TRAIN_PEAK_GB; its fp32 check at
# B = 1 over that layer.
VLM_ARCH = "internvl2-76b"
VLM_LAYERS = 8
VLM_PARAMS = 8_972_804_096
VLM_PROMPTS = (96, 128)
VLM_DECODE = 16
VLM_CHECK_LAYERS = 1
VLM_TRAIN = dict(steps=4, batch=4, seq=64, layers=1)
VLM_TRAIN_PARAMS = 2_983_223_296
VLM_CHECK_BATCH = 1
# the decode_32k cell of Qwen2-0.5B (B = 128 against 32,768 slots, the
# dry run's shape) at full width and all 24 layers, decoding at pos =
# 32,767 so that every page is read, as the dry run's count on meta
# charges them: first with the int8 cache (the kv_int8 variant, 25.77 GB
# of random int8 on the card), then with the bf16 cache (51.54 GB), the
# caches freed in between; CELL_STEPS steps counted, each step's launches
# exact, the device time held to the dry run's bound for the cell
CELL_ARCH = "qwen2-0.5b"
CELL_SHAPE = "decode_32k"
CELL_VARIANTS = ("kv_int8", "base")
CELL_STEPS = 4
# the fp32 check: one decode step at B = 2 over 256 slots of int8 cache,
# fp32 activations, on the card against the CPU
CELL_CHECK_BATCH = 2
CELL_CHECK_SLOTS = 256
# one device's share of CodeQwen1.5-7B on the 32 x 8 mesh
# (launch.mesh.make_production_mesh): rank 0 of a fake process group of
# 256, its shards of the full width and all 32 layers drawn on the card;
# every rule divides at model = 8 (32 heads and kv heads, d_ff 13,440,
# vocabulary 92,416), so rank 0 holds 4 of the 32 heads.  decode_32k: 4
# of the 128 sequences against 32,768 slots at pos = 32,767; prefill_32k:
# 1 of the 32 sequences of 32,768 tokens; train_4k: 8 of the 256
# sequences of 4,096 tokens through the train step (forward, backward
# under the model's remat="full", the ZeRO AdamW step); decode_32k under
# the kv_seqshard variant: the cache's slots over "model", so rank 0 holds
# 4 sequences' first 4,096 slots of all 32 kv heads, q's heads gathered.
# SHARE_STEPS steps each (the train step's 2: its host dispatch takes
# some 2.2 s a step, and the whole run must keep to its time limit on
# slow hosts); the slot-sharded decode then one more at SEQSHARD_POS,
# a slot of rank 0's own (at pos = 32,767 its slots are all live and it
# writes nothing, the new key lying on the last "model" rank's shard).
# Then InternVL2-76B's train_4k share on the same mesh, full width and
# all 80 layers: rank 0 holds 8 of the 64 query heads and 1 of the 8 kv
# heads, and 8 sequences of 1,025 projected patches and 3,071 tokens
SHARE_ARCH = "codeqwen1.5-7b"
SHARE_CELLS = ((SHARE_ARCH, "decode_32k", ()), (SHARE_ARCH, "prefill_32k", ()),
               (SHARE_ARCH, "train_4k", ()),
               (SHARE_ARCH, "decode_32k", ("kv_seqshard",)),
               (VLM_ARCH, "train_4k", ()))
SHARE_STEPS = {"decode_32k": 3, "prefill_32k": 3, "train_4k": 2,
               "decode_32k kv_seqshard": 3}
SEQSHARD_POS = 2047
# the prefill's plain attention runs in chunks of queries (a whole
# [4, 32768, 32768] fp32 score matrix is 17.2 GB, and the plain version
# makes several)
SHARE_PLAIN_CHUNK = 2048


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
    for name in kpaged.WINDOWED:
        kpaged.WINDOWED[name] = 0


def read_counts() -> dict:
    """Launches by kernel, the windowed paged attention's among them
    again as ``WINDOWED_COUNT``, and the search's by window width, as
    ``"scan_window C=1"``."""
    out = {name: n for counts in COUNTERS for name, n in counts.items()}
    out[WINDOWED_COUNT] = kpaged.WINDOWED["paged_attention"]
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
    ``queued_ms`` over ``PROFILED_REPS`` calls (``reps`` where fewer):
    the calls' kernels and the gaps between them.  The profiler's
    reading over as many calls (``profiled``: each kernel's mean
    duration times its launches a call, summed) is printed beside it,
    so that the two methods' offset is on record for every row, but not
    taken: over a long run the profiler loses records, of whole readings
    (35 of 75 in one H100 run) or of some of a call's kernels."""
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
    calls = min(reps, PROFILED_REPS)
    prof_ms = profiled(fn, batches, calls)
    q_ms, _ = queued_ms(fn, batches, calls, call_ms)
    say(f"  device ms a call: queued {q_ms:.6f}, profiler {prof_ms}")
    return q_ms, call_ms


# the sleep kernel's cycles a ms at the H100 SXM's largest SM clock, so
# that a sleep lasts at least the time ``queued_ms`` asks (longer where
# the card runs slower)
SLEEP_CYCLES_PER_MS = 1_980_000


def queued_ms(fn, batches, calls: int, host_ms: float,
              tries: int = 3) -> tuple:
    """(device ms a call of ``fn``, whether every call queued): CUDA
    events around ``calls`` back-to-back calls, all queued behind a
    sleep kernel of twice ``host_ms`` a call (the host's cost of a call,
    or more), so that the host queues every call while the card sleeps
    and the events time the card's work: the calls' kernels and the gaps
    between them.  Where the host took longer to queue the calls than
    the card slept, the reading is taken again behind twice that time,
    ``tries`` times in all; a call that waits on the card (a host sync,
    or more kernels than the launch queue holds) never queues whole, and
    its reading, which then includes host time, says so."""
    sleep_ms = max(0.5, 2.0 * calls * host_ms)
    for _ in range(tries):
        before, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        before.record()
        torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(*batches[i % len(batches)])
        queued = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        slept = before.elapsed_time(start)
        ms = start.elapsed_time(end) / calls
        if queued <= slept:
            return ms, True
        sleep_ms = 2.0 * queued
    say(f"  queued_ms: the host took {queued:.3f} ms to queue {calls} "
        f"calls and the card slept {slept:.3f} ms: {ms:.6f} ms a call "
        "includes host time")
    return ms, False


def profiled(fn, batches, calls: int):
    """Device ms a call of ``fn`` over ``calls`` calls under the
    profiler (see ``time_calls``), its three longest kernels printed;
    None when it records no device kernel."""
    with torch.profiler.profile(activities=CARD_ACTIVITY) as prof:
        for i in range(calls):
            fn(*batches[i % len(batches)])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total / e.count * max(1, round(e.count / calls))
                 for e in kernels if e.count)
    names = sorted(kernels, key=lambda e: -e.device_time_total)[:3]
    say("  profiler: " + ("; ".join(
        f"{e.key[:60]} x{e.count} {e.device_time_total:.1f} us"
        for e in names) or "no device kernels recorded"))
    return dev_us / 1e3 if dev_us > 0 else None


def time_plain(fn, batches):
    """(device ms, call ms, whether the device reading is the card's
    alone) of one call of a plain version (the plain versions are no
    yardstick of speed, and some take seconds a call): one warm call on
    the host clock, then one call by ``queued_ms``, once.  Where the
    plain version runs more kernels than the launch queue holds (the
    scans' step-by-step loops) or waits on the card, its reading
    includes host time, and its row says so
    (``plain_host_inclusive``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*batches[0])
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    q_ms, whole = queued_ms(fn, batches[-1:], 1, call_ms, tries=1)
    return q_ms, call_ms, whole


def bound(n_bytes: float, ops: float):
    """Least time in ms: bytes over HBM bandwidth against lane
    operations over the lane rate, and which of the two bounds it."""
    return roofline.bound(n_bytes, ops, LANE_OPS_PER_S)


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
            **plain_of(timed), "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": shape}


def plain_of(timed: dict) -> dict:
    """A row's ``plain_ms``, and ``plain_host_inclusive`` where that
    reading includes host time (see ``time_plain``)."""
    return {"plain_ms": timed["plain_ms"], **(
        {"plain_host_inclusive": True} if timed.get("plain_host") else {})}


def time_kernel(name: str, fn, plain_fn, batches, reps: int = 640) -> dict:
    """The kernel's and the plain version's device time per call
    (``time_calls``; the plain version timed once, ``time_plain``)."""
    dev_ms, call_ms = time_calls(fn, batches, reps)
    plain_dev, plain_call, whole = time_plain(plain_fn, batches)
    say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms per launch; "
        f"plain: device {plain_dev} ms" + ("" if whole else
                                           " (host time included)")
        + f", call {plain_call:.6f} ms")
    return {"ms": dev_ms, "plain_ms": plain_dev, "plain_host": not whole}


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
                                       1)}
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
    library_ms = lib_dev
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
    library_ms = lib_dev
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
    library_ms = lib_dev
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

def serve_prompts(vocab: int, seed: int, n: int = SERVE_REQUESTS) -> list:
    """``n`` prompts of 256-512 tokens sharing a 128-token prefix (the
    first n of the same draws)."""
    rng = np.random.default_rng(seed + 11)
    prefix = rng.integers(1, vocab, SERVE_PREFIX).tolist()
    return [prefix + rng.integers(1, vocab, int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)) - SERVE_PREFIX).tolist()
        for _ in range(n)]


def drive_server(server, phases: list, *, pipelined: bool, tag: str,
                 max_len: int = SERVE_MAX_LEN):
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
            server.step(max_len, pipelined=pipelined)
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


def front_len(cfg) -> int:
    """The positions before the text: InternVL's patches, or 0."""
    return cfg.vision.n_patches if cfg.vision is not None else 0


def prefilled(model, prompt: list, slots: int, inputs=None):
    """One request's prefill on ``model``, with its frames or patches
    (``inputs``, [1, ...] tensors) where the model has a front end: the
    logits and the caches ``decode_step`` continues from (k and v padded
    to ``slots``, the serving path's, as the engine pads them; recurrent
    state as it comes)."""
    dev = model.device
    batch = {"tokens": torch.tensor([prompt], device=dev)}
    batch.update({k: v.to(dev) for k, v in (inputs or {}).items()})
    n = front_len(model.cfg) + len(prompt)
    logits, caches = model.prefill(batch, n)
    return logits, _pad_caches(caches, n, slots)


@contextlib.contextmanager
def routing():
    """Record every MoE layer's routing inside the block: yields a list
    that gains, a layer at a time, (device type, experts [S, K], router
    probabilities [S, E] fp32)."""
    seen = []
    real = ffn_mod._route

    def spy(p, xt, cfg):
        out = real(p, xt, cfg)
        seen.append((xt.device.type, out[3].cpu(), out[1].float().cpu()))
        return out

    ffn_mod._route = spy
    try:
        yield seen
    finally:
        ffn_mod._route = real


def logit_runs(models: list, prompt: list, slots: int, inputs=None) -> list:
    """One request's prefill logits and 4 decode steps on each model (the
    first model's greedy tokens fed to all), as fp32 CPU tensors; with
    ``inputs`` (Whisper's frames or InternVL's patches, [1, ...]) fed to
    the prefill, each Whisper step given its model's ``_encode`` of the
    frames, InternVL's positions after its patches."""
    runs = []
    for model in models:
        logits, caches = prefilled(model, prompt, slots, inputs)
        enc = None
        if model.cfg.encdec is not None:
            with torch.no_grad():
                enc = model._encode(inputs["frames"])
        runs.append((model, [logits.float().cpu()], caches, enc))
    tokens = [int(torch.argmax(runs[0][1][0][0]))]
    for step in range(4):
        for model, out, caches, enc in runs:
            dev = model.device
            pos = front_len(model.cfg) + len(prompt) + step
            logits, _ = model.decode_step(
                torch.tensor([tokens[-1]], device=dev), caches,
                torch.tensor([pos], device=dev), enc=enc,
                page_size=SERVE_PAGE)
            out.append(logits.float().cpu())
        tokens.append(int(torch.argmax(runs[0][1][-1][0])))
    for out in runs:
        check(all(bool(torch.isfinite(x).all()) for x in out[1]),
              "serving: non-finite logits")
    return [out for _, out, _, _ in runs]


def worst_rel(got: list, want: list) -> float:
    """The largest difference over the largest logit, over every step."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def serving_path(arch: str, seed: int, extra: tuple = (), *,
                 reduced: bool = False, depth=None,
                 requests: int = SERVE_REQUESTS,
                 max_len: int = SERVE_MAX_LEN) -> dict:
    """The serving workload on ``arch`` at full width (or at its
    ``reduced()`` widths), cut to its first ``depth`` layers where given:
    ``requests`` requests, half before the crash and half after it, with
    ``extra`` prompt lengths joining the last phase, every request's
    cache ``max_len`` rounded up to whole pages."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    full_depth = cfg.n_layers
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    lm = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    say(f"serving: {cfg.name} at {'reduced' if reduced else 'full'} width "
        f"({cfg.n_layers} of {full_depth} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"/ {cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}"
        + (f"; layers {layer_kinds(cfg)}" if cfg.family == "hybrid" else "")
        + (f"; {cfg.moe}" if cfg.moe else "")
        + (f"; sliding window {cfg.sliding_window}" if cfg.sliding_window
           else "")
        + f"): {n_params} parameters, {n_bytes} bytes on {lm.device}, drawn "
        f"in {time.perf_counter() - t0:.3f} s")
    prompts = serve_prompts(cfg.vocab, seed, requests)
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
                    server, phases, pipelined=mode == "pipelined", tag=tag,
                    max_len=max_len)
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
            "slots": -(-max_len // SERVE_PAGE) * SERVE_PAGE,
            "decode_lens": (min(lens), max(lens)),
            "prefills": 2 * n_reqs,
            "decode_steps": sum(run[0].stats["decode_steps"]
                                for run in runs.values())}


def first_layers(lm, n_layers: int):
    """``lm`` cut to its first ``n_layers`` layers (``lm`` itself at its
    own depth): a model of that depth drawn on the card, then given
    ``lm``'s own tensors (no copy), so a check can copy those layers
    alone and never the whole served model."""
    if n_layers == lm.cfg.n_layers:
        return lm
    small = LM(dataclasses.replace(lm.cfg, n_layers=n_layers),
               device=lm.device)
    own = lm.state_dict()
    small.load_state_dict({name: own[name] for name in small.state_dict()},
                          assign=True)
    return small


def expert_sets_agree(name: str, card: list, cpu: list, top_k: int):
    """Each token's top-K expert set on the card against the CPU, step by
    step (the prefill, then each decode step: its MoE layers in order).
    A set that differs fails the run unless the CPU's K-th and (K+1)-th
    router probabilities lie within ``ROUTER_TIE``: that near-tie is
    printed, and the step it falls in is returned (the flip, not a
    kernel, moves that step's logits and the later steps').  Returns the
    number of sets compared up to the flip and its step, or None."""
    n = 0
    for step, (card_calls, cpu_calls) in enumerate(zip(card, cpu)):
        check(len(card_calls) == len(cpu_calls), f"{name}: the card and "
              "the CPU ran different numbers of MoE layers")
        for layer, ((_, e_card, _), (_, e_cpu, probs)) in enumerate(
                zip(card_calls, cpu_calls)):
            same = (e_card.sort(-1).values == e_cpu.sort(-1).values).all(-1)
            n += same.numel()
            if bool(same.all()):
                continue
            top = probs.sort(-1, descending=True).values
            gaps = (top[:, top_k - 1] - top[:, top_k])[~same]
            check(bool((gaps < ROUTER_TIE).all()), f"{name}: step {step}, "
                  f"MoE layer {layer}: {int((~same).sum())} tokens routed "
                  "to other experts on the card than on the CPU, with "
                  f"router gaps up to {float(gaps.max()):.3e}")
            say(f"{name}: step {step}, MoE layer {layer}: a router near-tie "
                f"(gap {float(gaps.max()):.3e} < {ROUTER_TIE}) routed "
                f"{int((~same).sum())} tokens to other experts")
            return n, step
    return n, None


def serving_cpu_check(served: dict, pick, n_layers=None, *,
                      bf16: bool = False) -> None:
    """The card against the CPU's plain versions on the served weights,
    at the model's width and its first ``n_layers`` layers (all where
    None), over the path's prompt that ``pick`` (``min`` or ``max`` by
    length) chooses and 4 decode steps.  Qwen2-0.5B (``bf16``): the
    served bf16 model on both sides, within ``LOGIT_REL_TOL``; every
    other model: its weights upcast to fp32 on both sides, within
    ``FP32_LOGIT_REL_TOL``.  Frees the served model first, so that it
    and the check's copies never share the card.  Where the model has
    MoE layers, every token's top-K expert set is compared
    (``expert_sets_agree``).  Where ``served`` holds ``inputs`` (Whisper's
    frames or InternVL's patches, a row a prompt), each prompt's row goes
    with it, upcast to fp32.  A printed router near-tie leaves the steps
    from the flip on ungated and sends the check to the path's next
    prompt in ``pick``'s order, up to ``TIE_PROMPTS`` prompts, and the
    check fails unless one prompt ran with every set equal and every
    step gated."""
    t0 = time.perf_counter()
    cfg, name = served["cfg"], served["cfg"].name
    small = first_layers(served.pop("lm"), n_layers or cfg.n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in small.parameters())
    at = f"{small.cfg.n_layers} of {cfg.n_layers} layers"
    # the CPU copy first: the card then holds the bf16 model and one
    # copy at a time
    if bf16:
        cpu_m = copy.deepcopy(small).cpu()
        card_m, what, tol = small, "bf16", LOGIT_REL_TOL
    else:
        cpu_m = copy.deepcopy(small).cpu().float()
        card_m, what, tol = (copy.deepcopy(small).float(), "fp32",
                             FP32_LOGIT_REL_TOL)
    del small
    n_moe = sum(ffn == "moe" for _, ffn in layer_kinds(card_m.cfg))
    every = served["prompts"]
    picked = sorted(range(len(every)), key=lambda i: len(every[i]),
                    reverse=pick is max)[:TIE_PROMPTS]
    front = served.get("inputs")
    for i in picked:
        prompt = every[i]
        inputs = None if front is None else {
            k: v[i:i + 1].float().cpu() for k, v in front.items()}
        with routing() as routes:
            card, cpu = logit_runs([card_m, cpu_m], prompt, served["slots"],
                                   inputs)
        flip, extra = None, ""
        if n_moe:
            # each step runs the MoE layers in order, on each device
            check(len(routes) == 2 * len(card) * n_moe, f"{name}: "
                  f"{len(routes)} MoE layers ran, not {n_moe} a step on "
                  "each device")
            steps = {dev: [r for r in routes if r[0] == dev]
                     for dev in ("cuda", "cpu")}
            steps = {dev: [rs[i:i + n_moe] for i in range(0, len(rs), n_moe)]
                     for dev, rs in steps.items()}
            check(len(steps["cuda"]) == len(steps["cpu"]) == len(card),
                  f"{name}: the MoE layers did not run on the card and on "
                  "the CPU once a step each")
            n_sets, flip = expert_sets_agree(name, steps["cuda"],
                                             steps["cpu"], cfg.moe.top_k)
            extra = (f"; {n_sets} top-{cfg.moe.top_k} expert sets compared, "
                     + ("all equal" if flip is None else
                        f"a printed near-tie at step {flip}"))
        gated = len(card) if flip is None else flip
        rel = worst_rel(card[:gated], cpu[:gated]) if gated else 0.0
        check(rel <= tol, f"{name}: card logits differ from the CPU's by "
              f"{rel:.6f} of the largest logit ({what}, {at}, tolerance "
              f"{tol})")
        say(f"{name}: prefill ({len(prompt)} tokens"
            + ("" if front is None else f", with its {', '.join(front)}")
            + ") and 4 decode steps at "
            f"{at} ({n_params} parameters), {what} "
            f"on the card against the CPU's plain versions: max |diff| / "
            f"max |logit| = {rel:.6f} over {gated} of {len(card)} steps "
            f"(tolerance {tol}){extra}; {time.perf_counter() - t0:.3f} s")
        if flip is None:
            break
    else:
        check(False, f"{name}: a router near-tie in each of the "
              f"{len(picked)} prompts checked: no run compared every "
              "expert set and gated every step")
    del card_m, cpu_m
    gc.collect()
    torch.cuda.empty_cache()


def decode_busy(serve: dict) -> None:
    """Where a decode step's time goes: ``BUSY_STEPS`` steps of one
    request at B = 1, as the engine runs them, timed on the host clock
    (each step ends in the argmax that syncs), then the same steps under
    the profiler for the summed device time and the count of CUDA kernels
    a step.  Busy share = device time over host time."""
    steps = BUSY_STEPS
    lm = serve["lm"]
    prompt = max(serve["prompts"], key=len)
    dev = lm.device
    logits, caches = prefilled(lm, prompt, serve["slots"])
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
    with torch.profiler.profile(activities=CARD_ACTIVITY) as prof:
        run(len(prompt))
        torch.cuda.synchronize()
    dev_ms, n, kernels = device_totals(prof)
    dev_ms, n = dev_ms / steps, n / steps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:4]
    say(f"serving {serve['cfg'].name} decode, B=1, position {len(prompt)}: "
        f"{host_ms:.3f} ms a step on the host clock, {dev_ms:.3f} ms of "
        f"device time in {n:.0f} CUDA kernels a step; device busy share "
        f"{dev_ms / host_ms:.4f}; top kernels: " + "; ".join(
            f"{e.key[:50]} {e.device_time_total / 1e3 / steps:.4f} ms"
            for e in top))


def serving_run(arch: str, seed: int, launches: dict, split: dict, *,
                extra: tuple = (), reduced: bool = False, depth=None,
                requests: int = SERVE_REQUESTS,
                max_len: int = SERVE_MAX_LEN,
                pick=min, cpu_layers=None, bf16_check: bool = False
                ) -> dict:
    """One serving path: ``serving_path`` with the counts set to 0 just
    before it and read just after; the index kernels launched, the
    attention kernels too where the model has attention (the windowed
    paged launches all of them where it has a window, none where it has
    not), and each scan (``wkv6``, ``ssd``) once per layer of its mixer
    per prefill and per decode step; then the decode busy share and the
    CPU check (``serving_cpu_check``), which
    frees the model.  Adds the path's launches to ``launches`` and its
    scans' to ``split``; returns the path's dict without its model."""
    reset_counts()
    t0 = time.perf_counter()
    served = serving_path(arch, seed, extra, reduced=reduced, depth=depth,
                          requests=requests, max_len=max_len)
    counts = read_counts()
    cfg = served["cfg"]
    check(served["lm"].device.type == "cuda", f"the {cfg.name} serving "
          "path's model is not on the card")
    say(f"{cfg.name} serving path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    mixers = [mixer for mixer, _ in layer_kinds(cfg)]
    for name in (("flash_attention", "paged_attention") * ("attn" in mixers)
                 + ("probe64_fp", "art_descend", "art_pack_entries",
                    "scan_window")):
        check(counts[name] > 0, f"{name} was not launched on the "
              f"{cfg.name} serving path")
    windowed = counts[WINDOWED_COUNT]
    if cfg.sliding_window is not None:
        check(windowed == counts["paged_attention"] > 0, f"{cfg.name} "
              f"decodes with a window of {cfg.sliding_window}, but "
              f"{windowed} of {counts['paged_attention']} paged_attention "
              "launches took it")
    else:
        check(windowed == 0, f"{cfg.name} has no window, but {windowed} "
              "paged_attention launches took one")
    for mixer, scan in (("rwkv", "wkv6"), ("mamba", "ssd")):
        n = mixers.count(mixer)
        want = n * (served["prefills"] + served["decode_steps"])
        check(counts[scan] == want, f"{scan} was launched {counts[scan]} "
              f"times on the {cfg.name} serving path, not {n} per prefill "
              f"({served['prefills']}) and per decode step "
              f"({served['decode_steps']}): {want}")
        if n:
            split[scan]["prefill"] += n * served["prefills"]
            split[scan]["decode"] += n * served["decode_steps"]
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    decode_busy(served)
    serving_cpu_check(served, pick, cpu_layers, bf16=bf16_check)
    say(f"{cfg.name} path and its checks: {time.perf_counter() - t0:.3f} s; "
        f"card memory after its model was freed "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return served


def attn_bound(n_bytes: float, flops: float):
    """Least time in ms: bytes over HBM bandwidth against FLOPs over the
    bf16 tensor-core rate, and which of the two bounds it."""
    return roofline.bound(n_bytes, flops, BF16_FLOPS_PER_S)


def work_bound(work: roofline.Work):
    """``attn_bound`` of a kernel's work (``analysis.roofline``'s
    formulas, the dry run's count of the same kernel)."""
    return attn_bound(work.bytes, work.flops)


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
        f"{float(plain.float().abs().max()):.6f}, "
        f"{float((diff / limit).max()):.4f} of the limit); {variant} "
        f"breaks the limit at {caught} of {plain.numel()} elements (max "
        f"abs {float((dropped.float() - plain.float()).abs().max()):.6f})")
    return err


def flash_vs_plain(serve: dict, coder: dict, seed: int,
                   launches: dict) -> list:
    """flash_attention at the prefill shapes (T = S = 256 and 512, the
    full width's heads, bf16); ``scaled_dot_product_attention`` on the
    same inputs (kv heads repeated beforehand) is the library call.  Then
    the windowed prefill at StarCoder2's heads and window over its long
    prompt (T = S = 4352): within the same limit of its plain version,
    which the plain version without the window breaks; timed, with its
    bound (the keys each query sees) and SDPA with the window as a
    boolean mask as its library call, under the row's ``window`` key."""
    cfg = serve["cfg"]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)

    def draw(T, H, Hk, dh, n):
        return [tuple(torch.randn(shape, generator=gen, device=dev)
                      .to(torch.bfloat16)
                      for shape in ((1, T, H, dh), (1, T, Hk, dh),
                                    (1, T, Hk, dh))) for _ in range(n)]

    out = None
    err = 0.0
    for T in SERVE_PROMPT:
        batches = draw(T, H, Hk, dh, 8)
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
        # the same forward writing its log-sum-exp, as training runs it
        lse_dev, lse_call = time_calls(
            lambda a, b, c: kflash.flash_attention(a, b, c, return_lse=True),
            batches, 64)
        timed["with_lse_ms"] = lse_dev
        say(f"flash_attention (T={T}): without its log-sum-exp "
            f"{timed['ms']} ms, with it {timed['with_lse_ms']} ms (device "
            f"{lse_dev} ms, call {lse_call:.6f} ms)")
        lib = [(a.transpose(1, 2).contiguous(),
                b.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous(),
                c.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous()) for a, b, c in batches]
        lib_dev, lib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=True), lib, 64)
        library_ms = lib_dev
        # the bound's pairs: half the T x T square
        bms, by = work_bound(flash_work(1, T, T, H, Hk, dh, T * T / 2))
        say(f"flash_attention (T={T}): bound {bms:.9f} ms ({by}); "
            f"scaled_dot_product_attention: device {lib_dev} ms, call "
            f"{lib_call:.6f} ms")
        out = (timed, bms, by, library_ms, T)
    timed, bms, by, library_ms, T = out

    # the windowed prefill: each query sees its last W keys
    ccfg = coder["cfg"]
    W, T_long = ccfg.sliding_window, CODER_LONG
    cH, cHk, cdh = ccfg.n_heads, ccfg.n_kv_heads, ccfg.head_dim
    batches = draw(T_long, cH, cHk, cdh, 2)
    q, k, v = batches[0]
    got = kflash.flash_attention(q, k, v, window=W)
    torch.cuda.synchronize()
    close(f"flash_attention windowed ({ccfg.name}, T={T_long}, W={W})", got,
          kflash.attention_plain(q, k, v, window=W),
          kflash.attention_plain(q, k, v), "the plain version without "
          "the window")
    wtimed = time_kernel(f"flash_attention windowed (T={T_long}, W={W})",
                         lambda a, b, c: kflash.flash_attention(a, b, c,
                                                                window=W),
                         lambda a, b, c: kflash.attention_plain(a, b, c,
                                                                window=W),
                         batches, reps=64)
    wbms, wby = work_bound(flash_work(1, T_long, T_long, cH, cHk, cdh,
                                      seen_pairs(T_long, T_long, W)))
    # the library call: SDPA with the window as a boolean mask (kv heads
    # repeated beforehand)
    pos = torch.arange(T_long, device=dev)
    wmask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    wlib = [(a.transpose(1, 2).contiguous(),
             b.repeat_interleave(cH // cHk, dim=2).transpose(1, 2)
             .contiguous(),
             c.repeat_interleave(cH // cHk, dim=2).transpose(1, 2)
             .contiguous()) for a, b, c in batches]
    wlib_dev, wlib_call = time_calls(
        lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
            a, b, c, attn_mask=wmask), wlib, 16)
    wlibrary_ms = wlib_dev
    say(f"flash_attention windowed (T={T_long}, W={W}): bound {wbms:.9f} ms "
        f"({wby}); scaled_dot_product_attention with the window as a "
        f"boolean mask: device {wlib_dev} ms, call {wlib_call:.6f} ms")
    del wlib, wmask
    others = []
    for tag, fB, fT, fS, fH, fHk, fdh, causal in FRONT_FWD_SHAPES:
        mask = "causal" if causal else "not causal"
        name = (f"flash_attention ({tag}, B={fB}, T={fT}, S={fS}, H={fH}, "
                f"Hk={fHk}, dh={fdh}, {mask})")
        batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                         .to(torch.bfloat16)
                         for shape in ((fB, fT, fH, fdh), (fB, fS, fHk, fdh),
                                       (fB, fS, fHk, fdh))) for _ in range(4)]
        q, k, v = batches[0]
        got = kflash.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        plain = kflash.attention_plain(q, k, v, causal=causal)
        if causal:
            broken = torch.cat([plain[:, :1], kflash.attention_plain(
                q[:, 1:], k[:, :-1], v[:, :-1])], dim=1)
            variant = "a dropped newest key"
        elif fT > 1:
            broken, variant = kflash.attention_plain(
                q, k, v), "the plain version with a causal mask"
        else:
            # one query sees every key under either mask: drop the last
            # key tile's rows instead (28 of 1500 = 23 * 64 + 28)
            tail = fS % 64 or 64
            broken, variant = kflash.attention_plain(
                q, k[:, :-tail], v[:, :-tail], causal=False), (
                f"the plain version without the last {tail} keys")
        ferr = close(name, got, plain, broken, variant)
        share = float(((got.float() - plain.float()).abs()
                       / attn_limit(plain)).max())
        ftimed = time_kernel(
            name, lambda a, b, c: kflash.flash_attention(a, b, c,
                                                         causal=causal),
            lambda a, b, c: kflash.attention_plain(a, b, c, causal=causal),
            batches, reps=64)
        flib = [(a.transpose(1, 2).contiguous(),
                 b.repeat_interleave(fH // fHk, dim=2).transpose(1, 2)
                 .contiguous(),
                 c.repeat_interleave(fH // fHk, dim=2).transpose(1, 2)
                 .contiguous()) for a, b, c in batches]
        flib_dev, flib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=causal), flib, 64)
        pairs = seen_pairs(fT, fS, None) if causal else fT * fS
        fbms, fby = work_bound(flash_work(fB, fT, fS, fH, fHk, fdh, pairs))
        say(f"{name}: bound {fbms:.9f} ms ({fby}); "
            f"scaled_dot_product_attention: device {flib_dev} ms, call "
            f"{flib_call:.6f} ms")
        others.append({"max_abs_err": ferr, "limit_share": share,
                       "ms": ftimed["ms"], **plain_of(ftimed),
                       "bound_ms": fbms, "bound_by": fby,
                       "library_ms": flib_dev,
                       "shape": f"{tag}, B={fB}, T={fT}, S={fS}, H={fH}, "
                                f"Hk={fHk}, dh={fdh}, {mask}, bf16"})
        del batches, flib
    say(f"flash_attention: main-path launches {launches['flash_attention']}")
    out = row("flash_attention", launches, err, timed, bms, by, library_ms,
              f"{cfg.name} prefill, T=S={T}, H={H}, Hk={Hk}, dh={dh}, bf16")
    out["with_lse_ms"] = timed["with_lse_ms"]
    out["window"] = {"ms": wtimed["ms"], **plain_of(wtimed),
                     "bound_ms": wbms, "bound_by": wby,
                     "library_ms": wlibrary_ms,
                     "shape": f"{ccfg.name} prefill, T=S={T_long}, W={W}, "
                              f"H={cH}, Hk={cHk}, dh={cdh}, bf16"}
    out["other_shapes"] = others
    return [out]


# the encoder-decoder and VLM paths' attention shapes: Whisper-tiny's
# encoder over its 1500 frames and its cross attention, not causal: 64
# queries of a batch of 4, a one-request prefill's 43 (a partial query
# tile) and a decode step's one query of each of the 4 requests, each
# against the 1500 encoder rows; InternVL2-76B's prefill over 1025
# patches and 128 text tokens, causal
FRONT_FWD_SHAPES = (
    ("Whisper-tiny encoder", 1, 1500, 1500, 6, 6, 64, False),
    ("Whisper-tiny cross", 4, 64, 1500, 6, 6, 64, False),
    ("Whisper-tiny cross, prefill", 1, 43, 1500, 6, 6, 64, False),
    ("Whisper-tiny cross, decode", 4, 1, 1500, 6, 6, 64, False),
    ("InternVL2-76B prefill", 1, 1153, 1153, 64, 8, 128, True))


def paged_lengths(tag: str, dims: tuple, slots: int, lengths, gen, dev,
                  window=None) -> tuple:
    """paged_attention at each of ``lengths``: one sequence with ``dims``
    = (H, Hk, dh) over a dense cache of ``slots`` slots read as pages
    through the identity table, bf16, with a sliding ``window`` or none.
    Each is held to ``ATTN_STEPS`` of its plain version (which a dropped
    newest key, or without a window the window's absence, breaks) and
    timed, beside ``scaled_dot_product_attention`` over the live keys
    (kv heads repeated beforehand) and the bound.  Returns the largest
    error and (timed, bound, bound_by, library ms) at the last length."""
    H, Hk, dh = dims
    n_pages = slots // SERVE_PAGE
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    err = 0.0
    for length in lengths:
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        live = min(length, window or length)  # keys each call reads
        batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                         .to(torch.bfloat16)
                         for shape in ((1, H, dh), (n_pages, SERVE_PAGE, Hk,
                                                    dh),
                                       (n_pages, SERVE_PAGE, Hk, dh)))
                   for _ in range(8)]
        q, pk, pv = batches[0]
        got = kpaged.paged_mqa(q, pk, pv, table, lens, window)
        torch.cuda.synchronize()
        plain = kpaged.paged_attention_plain(q, pk, pv, table, lens, window)
        if window is None:
            broken, variant = kpaged.paged_attention_plain(
                q, pk, pv, table, lens - 1), "a dropped newest key"
        else:
            broken, variant = kpaged.paged_attention_plain(
                q, pk, pv, table, lens), "the plain version without the window"
        err = max(err, close(f"{tag} (len={length}, {slots} slots)", got,
                             plain, broken, variant))
        timed = time_kernel(
            f"{tag} (len={length})",
            lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens, window),
            lambda a, b, c: kpaged.paged_attention_plain(a, b, c, table,
                                                         lens, window),
            batches, reps=256)
        lib = [(a[:, :, None],
                b.reshape(1, slots, Hk, dh)[:, length - live:length]
                .repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous(),
                c.reshape(1, slots, Hk, dh)[:, length - live:length]
                .repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                .contiguous()) for a, b, c in batches]
        lib_dev, lib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c), lib, 256)
        library_ms = lib_dev
        # the live keys and values once, q, the table's live entries, the
        # output
        work = paged_work([live], H, Hk, dh, SERVE_PAGE)
        n_bytes = work.bytes
        bms, by = work_bound(work)
        say(f"{tag} (len={length}, {live} live keys): bound {bms:.9f} ms "
            f"({by}, {n_bytes} bytes); scaled_dot_product_attention over "
            f"the live keys: device {lib_dev} ms, call {lib_call:.6f} ms")
    return err, (timed, bms, by, library_ms)


def paged_vs_plain(serve: dict, coder: dict, seed: int,
                   launches: dict, fronts: tuple = ()) -> list:
    """paged_attention at Qwen2-0.5B's decode shape (one sequence, the
    path's dense cache read as pages, at the shortest and longest length
    a request reached), then with a sliding window at StarCoder2-15B's
    (B = 1, its heads and window of 4096, its long prompt's decode
    lengths over its cache), then at the decode shapes of ``fronts``
    (the Whisper and InternVL paths' dicts): one row, the windowed
    shape's numbers under its ``window`` key, the others' under
    ``other_shapes``, and the launches split by ``launches_by_shape``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    measured = []
    for tag, served, lengths, window in (
            ("paged_attention", serve, serve["decode_lens"], None),
            ("paged_attention windowed", coder,
             (CODER_LONG + 1, CODER_LONG + SERVE_NEW),
             coder["cfg"].sliding_window)) + tuple(
                (f"paged_attention {f['cfg'].name}", f, f["decode_lens"],
                 None) for f in fronts):
        cfg, slots = served["cfg"], served["slots"]
        dims = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        pages, n_splits = kpaged.split_plan(
            slots // SERVE_PAGE, 1, cfg.n_heads, cfg.n_kv_heads,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        say(f"{tag}" + ("" if cfg.name in tag else f" ({cfg.name})")
            + f": {n_splits} splits of {pages} pages (one "
            f"cluster a kv head), {n_splits * cfg.n_kv_heads} blocks")
        err, (timed, bms, by, library_ms) = paged_lengths(
            tag, dims, slots, lengths, gen, dev, window)
        measured.append((err, timed, bms, by, library_ms,
                         f"{cfg.name} decode, B=1, H={dims[0]}, "
                         f"Hk={dims[1]}, dh={dims[2]}, len={lengths[-1]}, "
                         + (f"window {window}, " if window else "")
                         + f"{slots} slots, bf16"))
    windowed = launches[WINDOWED_COUNT]
    split = {"no window": launches["paged_attention"] - windowed,
             "window": windowed}
    say(f"paged_attention: main-path launches {launches['paged_attention']}: "
        f"{split}")
    (err, timed, bms, by, library_ms, shape), w, *others = measured
    out = row("paged_attention", launches, max(err, w[0]), timed, bms, by,
              library_ms, shape)
    out["other_shapes"] = [
        {"max_abs_err": e, "ms": t["ms"], **plain_of(t),
         "bound_ms": b, "bound_by": y, "library_ms": lib, "shape": sh}
        for e, t, b, y, lib, sh in others]
    out["launches_by_shape"] = split
    out["window"] = {"max_abs_err": w[0], "ms": w[1]["ms"],
                     **plain_of(w[1]), "bound_ms": w[2],
                     "bound_by": w[3], "library_ms": w[4], "shape": w[5]}
    return [out]


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
    acts = CARD_ACTIVITY
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
    state within ``FP32_TOL`` of its largest magnitude.  No PyTorch op
    computes a WKV scan: no library call."""
    cfg = serve["cfg"]
    dh = cfg.rwkv.head_dim
    H = cfg.d_model // dh
    dev = torch.device("cuda", torch.cuda.current_device())
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
              s_err <= FP32_TOL * s_max, f"{name}: the final state differs "
              f"from "
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
                            reps=64 if T > 1 else 640)
        # the state terms: one FMA a state element for r.S and one for
        # the update, per token and head, at the fp32 rate
        work = wkv6_work(1, T, H, dh, r.element_size(), carried)
        n_bytes = work.bytes
        bms, by = bound(n_bytes, work.lane_ops)
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
    """fp32 outputs within ``FP32_TOL`` of the largest |plain|, a limit
    that ``broken`` (a plain version without a term) must break."""
    limit = FP32_TOL * float(plain.abs().max())
    err = float((got - plain).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= limit, f"{name}: "
          f"kernel differs from its plain version by {err} (limit {limit})")
    caught = int(((broken - plain).abs() > limit).sum())
    check(caught > 0, f"{name}: the limit does not see {variant}")
    say(f"{name}: within {FP32_TOL} of the largest |plain| (max abs err "
        f"{err:.3e}, largest |plain| {float(plain.abs().max()):.6f}, "
        f"{err / limit if limit else 0.0:.4f} of the limit); {variant} "
        f"breaks the limit at {caught} of {plain.numel()} elements")
    return err


def ssd_vs_plain(mp: dict, hybrid: dict, seed: int, launches: dict,
                 split: dict) -> list:
    """ssd at Jamba's full width (H = 256, dh = 64, N = 16): a prefill
    of T = 4096 from a zero state and decode steps (T = 1) from a carried
    state in bf16 and in fp32 (the Mamba path's decode hands the kernel
    fp32), and at the hybrid's reduced decode (fp32, where 7 of every 8
    of its launches are), on inputs drawn from the seed.  bf16 outputs
    elementwise within ``ATTN_STEPS`` bf16 unit roundoffs of the plain
    version, fp32 within ``FP32_TOL`` of the largest, limits that the
    plain version without the s = t term (prefill) or without the carried
    state (decode) breaks; the final state within ``FP32_TOL`` of its
    largest magnitude.  No PyTorch op computes an SSD scan: no library call."""
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
              s_err <= FP32_TOL * s_max, f"{name}: the final state differs "
              f"from "
              f"the plain version's by {s_err} (largest {s_max})")
        say(f"{name}: final state max abs err {s_err:.3e} (largest "
            f"{s_max:.3f})")
        timed = time_kernel(name, lambda *a: kssd.ssd(*a),
                            lambda *a: kssd.ssd_plain(*a), batches,
                            reps=64 if T > 1 else 640)
        # x and y, dt fp32, B_ and C_, A, the state in (when carried) and
        # out in fp32; the state terms: one FMA a state element for the
        # update and one for y, per token and head, at the fp32 rate
        work = ssd_work(1, T, H, dh, N, x.element_size(), carried)
        n_bytes = work.bytes
        bms, by = bound(n_bytes, work.lane_ops)
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


# -- the sixteenth path: training, and the attention backward kernel -------

def forward_launches(remat: str) -> int:
    """A layer's forward kernel's launches a train step under the model's
    remat policy: the forward, and under any policy but ``"none"`` its
    recompute in the backward (a region relaunches its kernels; ``dots``
    keeps only the products' outputs)."""
    return 1 if remat == "none" else 2


def remat_memory(seed: int, launches: dict) -> dict:
    """The count's temp bytes against the card (ROADMAP F3): one train
    step of MiniCPM-2B at full width on one card (``TRAIN_BATCH``
    sequences of ``TRAIN_SEQ`` tokens, fp32 AdamW state) under each
    remat policy, its peak memory (``max_memory_allocated``) less what
    was held before its model was drawn, printed beside the dry run's
    argument plus temp bytes for the same step (``lower_cell`` on the
    one-card mesh, on ``meta``); each step's loss finite, its forward
    kernels ``forward_launches`` a layer, its backward's once, no plain
    version.  Adds the launches to ``launches``; returns the readings by
    policy."""
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeCfg("train_small", "train", TRAIN_SEQ, TRAIN_BATCH)
    card_mesh = make_smoke_mesh()
    out = {}
    for policy in REMAT_POLICIES:
        t0 = time.perf_counter()
        low, _ = steps_mod.lower_cell(cfg, shape, card_mesh, remat=policy)
        costs, _ = roofline.count_costs(low.fn, *low.args)
        count = (dryrun.argument_bytes(low.arg_specs, low.shardings,
                                       card_mesh) + costs.temp_bytes) / 1e9
        del low, costs
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        lm = LM(cfg, seed=seed, device="cuda", remat=policy)
        state = adamw.init(dict(lm.named_parameters()))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = make_train_step(lm, cfg.name)
        with counting_plain() as plain:
            reset_counts()
            loss, state = step(batch, state)
            torch.cuda.synchronize()
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(not any(plain.values()), f"{cfg.name} step under remat "
              f"{policy}: a plain kernel version ran: {plain}")
        check(bool(torch.isfinite(loss)), f"{cfg.name} step under remat "
              f"{policy}: loss {loss}")
        want = {"flash_attention": cfg.n_layers * forward_launches(policy),
                "flash_attention_bwd": cfg.n_layers}
        got = {k: counts[k] for k in want}
        check(got == want, f"{cfg.name} step under remat {policy}: "
              f"launches {got}, not {want}")
        for k, v in got.items():
            launches[k] += v
        card = peak - held
        out[policy] = {"count_gb": count, "card_gb": card, "held_gb": held}
        say(f"{cfg.name} one-card train step (B = {TRAIN_BATCH}, T = "
            f"{TRAIN_SEQ}) under remat {policy}: loss {float(loss):.6f}; "
            f"peak card memory {peak:.3f} GB ({held:.3f} GB held before), "
            f"{card:.3f} GB the step's, against the count's argument + "
            f"temp {count:.3f} GB (count / card {count / card:.4f}); "
            f"launches {got}; {time.perf_counter() - t0:.3f} s")
        del lm, state, batch, step, loss
        gc.collect()
        torch.cuda.empty_cache()
    return out


def timed_step(step_fn, steps: int, timing: dict):
    """``step_fn`` (a train, prefill or decode step) wrapped to time each
    call on the host clock into ``timing["host_s"]`` (each call starts
    and ends with a synchronise) and to run the ``steps``-th call under
    the profiler, into ``timing["prof"]`` (its host time recorded as
    None)."""

    def step(*args):
        torch.cuda.synchronize()
        if len(timing["host_s"]) == steps - 1:
            with torch.profiler.profile(activities=CARD_ACTIVITY) as prof:
                out = step_fn(*args)
                torch.cuda.synchronize()
            timing["prof"] = prof
            timing["host_s"].append(None)
            return out
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        timing["host_s"].append(time.perf_counter() - t0)
        return out

    return step


def device_totals(prof) -> tuple:
    """(device ms, CUDA kernel count, the kernels' events) the profiler
    ``prof`` recorded."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels), kernels)


def train_full_width(seed: int) -> dict:
    """(a) ``train`` of MiniCPM-2B at full width on the card for
    ``TRAIN_STEPS`` steps, its train step wrapped by ``timed_step``; no
    plain kernel version may run.  Returns the run's dict, the plain
    versions' calls, the step times, the profile and the peak card
    memory."""
    timing = {"host_s": [], "prof": None}
    real = train_mod.make_train_step

    def timed_factory(*a, **kw):
        return timed_step(real(*a, **kw), TRAIN_STEPS, timing)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_mod.make_train_step = timed_factory
    try:
        with counting_plain() as plain:
            out = train_mod.train(TRAIN_ARCH, reduced=False,
                                  steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ, ckpt_every=10,
                                  seed=seed, verbose=False, device="cuda")
    finally:
        train_mod.make_train_step = real
    return {"out": out, "plain": dict(plain), "timing": timing,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_report(trained: dict) -> None:
    """(a)'s checks and numbers: the parameter count, every loss finite,
    no generation saved, no plain version, peak memory under
    ``TRAIN_PEAK_GB``; ms a step after the first; the profiled step's
    device time, kernel count and busy share (device time over the
    steps' host time, as ``decode_busy``)."""
    out, timing = trained["out"], trained["timing"]
    cfg = get_arch(TRAIN_ARCH)
    n = sum(t.numel() for t in out["params"].values())
    check(n == cfg.param_count() + cfg.d_model == TRAIN_PARAMS,
          f"{TRAIN_ARCH} holds {n:,} parameters, not {TRAIN_PARAMS:,}")
    check(all(t.device.type == "cuda" for t in out["params"].values()),
          "the trained parameters are not on the card")
    losses = out["losses"]
    check(out["final_step"] == TRAIN_STEPS == len(losses)
          and bool(np.isfinite(losses).all()), f"training {TRAIN_ARCH} gave "
          f"losses {losses}")
    check(out["store"].latest_step() is None, "a generation was saved at "
          "full width")
    check(not any(trained["plain"].values()), "a plain kernel version ran "
          f"on the training path: {trained['plain']}")
    check(trained["peak_gb"] < TRAIN_PEAK_GB, f"peak card memory "
          f"{trained['peak_gb']:.3f} GB is over {TRAIN_PEAK_GB} GB")
    host_ms = step_times(TRAIN_ARCH, timing)
    say(f"training {TRAIN_ARCH} at full width, remat {out['remat']}: {n:,} "
        f"parameters (the config's count {cfg.param_count():,} and the "
        f"final norm), B={TRAIN_BATCH}, T={TRAIN_SEQ}, {TRAIN_STEPS} steps; "
        "losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; step times (host clock) "
        + ", ".join("profiled" if t is None else f"{t * 1e3:.3f} ms"
                    for t in timing["host_s"])
        + f"; {host_ms:.3f} ms a step after the first; peak card memory "
        f"{trained['peak_gb']:.3f} GB")


def step_times(tag: str, timing: dict) -> float:
    """The mean host ms of the timed steps after the first, and a line of
    the profiled step's device time, kernel count, device busy share
    (device time over that mean, as ``decode_busy``) and top kernels."""
    host = [t for t in timing["host_s"][1:] if t is not None]
    host_ms = sum(host) / len(host) * 1e3
    dev_ms, n_k, kernels = device_totals(timing["prof"])
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
    say(f"training {tag} step (profiled): {dev_ms:.3f} ms of device "
        f"time in {n_k} CUDA kernels; device busy share "
        f"{dev_ms / host_ms:.4f}; top kernels: " + "; ".join(
            f"{e.key[:50]} x{e.count} {e.device_time_total / 1e3:.4f} ms"
            for e in top))
    return host_ms


def grad_check(what: str, cfg, params: dict, seed: int, batch: int,
               seq: int, inputs=None) -> None:
    """A model of ``cfg`` holding ``params`` (a trained model's weights,
    those of ``cfg``'s layers), upcast to fp32 (exactly), on the card and
    on the CPU: one batch's loss (with ``inputs``, CPU tensors of
    Whisper's frames or InternVL's patches, where the model takes them)
    within ``TRAIN_LOSS_TOL`` of the CPU's and each leaf's gradient
    within ``TRAIN_GRAD_TOL`` of its largest |g| on the CPU; fp32
    products in full fp32 on the card (no TF32).  Frees both models."""
    t0 = time.perf_counter()
    card = LM(cfg, seed=seed, device="cuda")
    card.load_state_dict({name: params[name].float()
                          for name in card.state_dict()}, assign=True)
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(seed + 24)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         size=(batch, seq + 1)))
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **(inputs or {})}
    losses, grads = [], []
    for lm in (card, cpu):
        lm.requires_grad_(True)
        loss = lm.loss(data)
        loss.backward()
        losses.append(loss.item())
        grads.append({name: p.grad.detach().cpu()
                      for name, p in lm.named_parameters()})
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, where = 0.0, None
    for name, want in grads[1].items():
        gap = float((grads[0][name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if gap >= worst:
            worst, where = gap, name
    say(f"{what} fp32 check (B={batch}, T={seq}): loss card "
        f"{losses[0]:.9f}, CPU {losses[1]:.9f} (relative {rel_loss:.3e}); "
        f"worst gradient {worst:.3e} of its leaf's largest ({where}), over "
        f"{len(grads[1])} leaves; {time.perf_counter() - t0:.3f} s")
    check(rel_loss <= TRAIN_LOSS_TOL, f"{what}: the card's fp32 loss "
          f"differs from the CPU's by {rel_loss:.3e}")
    check(worst <= TRAIN_GRAD_TOL, f"{what}: the card's fp32 gradient of "
          f"{where} differs from the CPU's by {worst:.3e} of its largest")
    del card, cpu, grads
    gc.collect()
    torch.cuda.empty_cache()


def train_cpu_check(params: dict, seed: int) -> None:
    """(b) the trained weights cut to ``TRAIN_CHECK_LAYERS`` layers at
    full width, held card against CPU by ``grad_check``."""
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    grad_check(f"training {TRAIN_ARCH} ({TRAIN_CHECK_LAYERS} of 40 layers, "
               "full width)", cfg, params, seed, TRAIN_CHECK_BATCH,
               TRAIN_SEQ)


def crash_restart_path(seed: int) -> dict:
    """(c) the crash and restart example's run on the card: MiniCPM-2B at
    ``reduced()``, a power failure at step 110, the restart from
    generation 100 at the committed cursor; it finishes at step 200 on
    every count, the loss falls, and generation 200 restores the live
    parameters bit for bit."""
    t0 = time.perf_counter()
    with counting_plain() as plain:
        out = train_mod.train(TRAIN_ARCH, seed=seed, verbose=False,
                              device="cuda", **CRASH_RUN)
    secs = time.perf_counter() - t0
    steps = CRASH_RUN["steps"]
    losses = out["losses"]
    store = out["store"]
    check(out["final_step"] == steps and out["data"].global_step == steps
          and store.latest_step() == steps, f"the crash and restart run "
          f"ended at step {out['final_step']}, cursor "
          f"{out['data'].global_step}, generation {store.latest_step()}")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"the crash and restart run's loss went {losses[0]} -> "
          f"{losses[-1]}")
    check(not any(plain.values()), "a plain kernel version ran on the crash "
          f"and restart run: {plain}")
    cfg = get_arch(TRAIN_ARCH).reduced()
    got = lm_params_from_arrays(store.restore(
        lm_arrays_from_params(out["params"], cfg), step=steps), cfg)
    for name, live in out["params"].items():
        live = live.cpu()
        check(got[name].dtype == live.dtype and torch.equal(
            got[name].view(torch.int16) if live.dtype == torch.bfloat16
            else got[name], live.view(torch.int16)
            if live.dtype == torch.bfloat16 else live),
            f"generation {steps}'s {name} differs from the live parameter")
    say(f"training {TRAIN_ARCH} reduced, remat {out['remat']}, crash at "
        f"step {CRASH_RUN['kill_at_step']} and restart: {len(losses)} losses, "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; final step {out['final_step']}"
        f", data cursor {out['data'].cursor}, generation "
        f"{store.latest_step()}; {len(got)} parameters of generation {steps} "
        f"equal the live parameters bit for bit; PMem {store.pmem.counters};"
        f" {secs:.3f} s")
    return out


# -- the seventeenth path: training the recurrent families ----------------

def recurrent_train(seed: int) -> dict:
    """(a) RWKV6-7B at full width cut to ``RECUR_LAYERS`` layers:
    ``RECUR_STEPS`` steps of ``make_train_step`` (AdamW at the
    architecture's schedule) on the token pipeline's batches of
    ``RECUR_BATCH`` x ``RECUR_SEQ``, as the JAX package's train loop
    runs a step, wrapped by ``timed_step``; every plain version's calls
    counted.
    Returns the config, the losses, the trained weights, the timing, the
    peak card memory and the plain versions' calls."""
    cfg = dataclasses.replace(get_arch(RECUR_ARCH), n_layers=RECUR_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, seed=seed, device="cuda")
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=RECUR_SEQ,
                                    global_batch=RECUR_BATCH, n_docs=256,
                                    mean_doc_len=128, seed=seed),
                         device=lm.device)
    losses, timing = [], {"host_s": [], "prof": None}
    step_fn = timed_step(make_train_step(lm, cfg.name,
                                         total_steps=RECUR_STEPS),
                         RECUR_STEPS, timing)
    state = adamw.init(dict(lm.named_parameters()))
    with counting_plain() as plain:
        for _ in range(RECUR_STEPS):
            batch = {k: torch.from_numpy(v).to(lm.device)
                     for k, v in data.next_batch().items()}
            loss, state = step_fn(batch, state)
            losses.append(float(loss))
            data.commit()
    return {"cfg": cfg, "losses": losses, "params": lm.state_dict(),
            "timing": timing, "plain": dict(plain), "remat": lm.remat,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def recurrent_report(trained: dict) -> None:
    """(a)'s checks and numbers: the parameter count, every loss finite,
    no plain version, peak memory under ``RECUR_PEAK_GB``; ms a step
    after the first and the profiled step's device time, kernel count
    and busy share."""
    cfg, params, timing = trained["cfg"], trained["params"], trained["timing"]
    n = sum(t.numel() for t in params.values())
    check(n == RECUR_PARAMS, f"{RECUR_ARCH} at {RECUR_LAYERS} layers holds "
          f"{n:,} parameters, not {RECUR_PARAMS:,}")
    check(all(t.device.type == "cuda" for t in params.values()),
          "the trained parameters are not on the card")
    losses = trained["losses"]
    check(len(losses) == RECUR_STEPS and bool(np.isfinite(losses).all()),
          f"training {RECUR_ARCH} gave losses {losses}")
    check(not any(trained["plain"].values()), "a plain kernel version ran "
          f"on the recurrent training path: {trained['plain']}")
    check(trained["peak_gb"] < RECUR_PEAK_GB, f"peak card memory "
          f"{trained['peak_gb']:.3f} GB is over {RECUR_PEAK_GB} GB")
    host_ms = step_times(f"{RECUR_ARCH} ({RECUR_LAYERS} of 32 layers)",
                         timing)
    say(f"training {RECUR_ARCH} at full width, {RECUR_LAYERS} of 32 layers, "
        f"remat {trained['remat']}: {n:,} parameters ({16 * n / 1e9:.3f} GB "
        "of training state at 16 "
        f"bytes each; the config's count {cfg.param_count():,}), B="
        f"{RECUR_BATCH}, T={RECUR_SEQ}, {RECUR_STEPS} steps; losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + "; step times (host clock) "
        + ", ".join("profiled" if t is None else f"{t * 1e3:.3f} ms"
                    for t in timing["host_s"])
        + f"; {host_ms:.3f} ms a step after the first; peak card memory "
        f"{trained['peak_gb']:.3f} GB")


def hybrid_train(seed: int) -> dict:
    """(c) ``train`` of the hybrid at ``reduced()`` on the card for
    ``HYBRID_TRAIN``'s steps; every loss finite and no plain version.
    Returns the run's dict."""
    t0 = time.perf_counter()
    with counting_plain() as plain:
        out = train_mod.train(HYBRID_ARCH, reduced=True, seed=seed,
                              verbose=False, device="cuda", **HYBRID_TRAIN)
    losses = out["losses"]
    check(out["final_step"] == HYBRID_TRAIN["steps"] == len(losses)
          and bool(np.isfinite(losses).all()), f"training {HYBRID_ARCH} "
          f"gave losses {losses}")
    check(not any(plain.values()), "a plain kernel version ran on the "
          f"hybrid's training: {plain}")
    say(f"training {HYBRID_ARCH} at reduced(), remat {out['remat']}: "
        f"B={HYBRID_TRAIN['batch']}, "
        f"T={HYBRID_TRAIN['seq_len']}, {len(losses)} steps; losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; {time.perf_counter() - t0:.3f} s")
    return out


def wkv_bwd_draw(gen, B: int, T: int, H: int, dh: int, dtype, logw_lo,
                 carried: bool) -> tuple:
    """r, k, v, do in ``dtype``; logw fp32 log-uniform in [logw_lo,
    -0.001]; u fp32; with ``carried`` a state and the final state's
    gradient fp32."""
    dev = gen.device
    r, k, v, do = (torch.randn((B, T, H, dh), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    lo, hi = np.log(1e-3), np.log(-logw_lo)
    logw = -torch.exp(lo + (hi - lo) * torch.rand(
        (B, T, H, dh), generator=gen, device=dev))
    u = torch.randn((H, dh), generator=gen, device=dev)
    state, dstate = (torch.randn((B, H, dh, dh), generator=gen, device=dev)
                     if carried else None for _ in range(2))
    return r, k, v, logw, u, do, state, dstate


def ssd_bwd_draw(gen, B: int, T: int, H: int, dh: int, N: int, dtype,
                 dt_hi: float, carried: bool) -> tuple:
    """x, dy [B, T, H, dh] and B_, C_ [B, T, N] in ``dtype``; dt fp32 in
    [0.001, dt_hi], A fp32 in [-1.5, -0.3]; with ``carried`` a state and
    the final state's gradient fp32."""
    dev = gen.device
    x, dy = (torch.randn((B, T, H, dh), generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    Bm, Cm = (torch.randn((B, T, N), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    dt = 0.001 + (dt_hi - 0.001) * torch.rand((B, T, H), generator=gen,
                                              device=dev)
    A = -(0.3 + 1.2 * torch.rand((H,), generator=gen, device=dev))
    state, dstate = (torch.randn((B, H, dh, N), generator=gen, device=dev)
                     if carried else None for _ in range(2))
    return x, dt, Bm, Cm, A, dy, state, dstate


def grads_close(name: str, parts: tuple, got, again, plain, broken,
                variant: str) -> float:
    """The backward kernel's outputs ``got`` against ``plain``, each by
    ``close`` (bf16) or ``close_fp32`` (fp32), whose limit its output of
    ``broken`` (a plain version with a fault that reaches every output)
    must break; ``again`` (a second call) bit-identical.  Returns the max
    abs error."""
    check(all((a is None and b is None) or torch.equal(a, b)
              for a, b in zip(got, again)), f"{name}: two calls on the same "
          "inputs differ")
    err = 0.0
    for part, g, p, b in zip(parts, got, plain, broken):
        if p is None:
            check(g is None, f"{name} {part}: a gradient where none is due")
            continue
        check(g.dtype == p.dtype and g.shape == p.shape, f"{name} {part}: "
              "an output of the wrong dtype or shape")
        same = close if g.dtype == torch.bfloat16 else close_fp32
        err = max(err, same(f"{name} {part}", g, p, b, variant))
    say(f"{name}: two calls bit-identical")
    return err


def ends_dropped(grad: torch.Tensor) -> torch.Tensor:
    """``grad`` [B, T, ...] with its first and last steps zeroed: a fault
    that reaches every output of a scan's backward (the last step's
    through the adjoint state to every earlier step, the first step's
    into the input state's gradient however strong the decay)."""
    cut = grad.clone()
    cut[:, 0] = 0
    cut[:, -1] = 0
    return cut


def recurrent_path(seed: int, launches: dict) -> None:
    """The recurrent training path: (a) RWKV6-7B at full width cut to
    ``RECUR_LAYERS`` layers, its launches counted and held to 8 of each
    scan kernel a step; (b) its fp32 check; (c) the hybrid at
    ``reduced()``, counted on its own, and its fp32 check.  Adds the
    counts to ``launches``."""
    t_recur = time.perf_counter()
    reset_counts()
    recur = recurrent_train(seed)
    counts = read_counts()
    say(f"recurrent training path (a): {time.perf_counter() - t_recur:.3f} "
        f"s; kernel launches {counts}")
    for name, per in (("wkv6", forward_launches(recur["remat"])),
                      ("wkv6_bwd", 1)):
        check(counts[name] == RECUR_STEPS * RECUR_LAYERS * per, f"{name} "
              f"was launched {counts[name]} times in {RECUR_STEPS} training "
              f"steps of {RECUR_LAYERS} RWKV6 layers under remat "
              f"{recur['remat']}")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    recurrent_report(recur)
    params = recur.pop("params")
    del recur
    gc.collect()
    torch.cuda.empty_cache()
    grad_check(f"training {RECUR_ARCH} ({RECUR_CHECK_LAYERS} of 32 layers, "
               "full width)", dataclasses.replace(
                   get_arch(RECUR_ARCH), n_layers=RECUR_CHECK_LAYERS),
               params, seed, RECUR_CHECK_BATCH, RECUR_CHECK_SEQ)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    hybrid_out = hybrid_train(seed)
    counts = read_counts()
    say(f"recurrent training path (c): {time.perf_counter() - t0:.3f} s; "
        f"kernel launches {counts}")
    hybrid_cfg = get_arch(HYBRID_ARCH).reduced()
    mixers = [mixer for mixer, _ in layer_kinds(hybrid_cfg)]
    fwd = forward_launches(hybrid_out["remat"])
    for name, mixer, per in (("ssd", "mamba", fwd), ("ssd_bwd", "mamba", 1),
                             ("flash_attention", "attn", fwd),
                             ("flash_attention_bwd", "attn", 1)):
        want = HYBRID_TRAIN["steps"] * mixers.count(mixer) * per
        check(counts[name] == want, f"{name} was launched {counts[name]} "
              f"times in the hybrid's training, not {want}")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    grad_check(f"training {HYBRID_ARCH} at reduced()", hybrid_cfg,
               hybrid_out["params"], seed, RECUR_CHECK_BATCH,
               RECUR_CHECK_SEQ)
    del hybrid_out
    gc.collect()
    torch.cuda.empty_cache()
    say(f"recurrent training path: {time.perf_counter() - t_recur:.3f} s")


# -- the eighteenth and nineteenth paths: Whisper and InternVL ------------

def front_inputs(cfg, gen, batch: int) -> dict:
    """Whisper's frames [B, n_audio_frames, d_model] or InternVL's
    patches [B, n_patches, d_vit]: normals drawn from ``gen`` on its
    device, bf16."""
    if cfg.encdec is not None:
        key, shape = "frames", (batch, cfg.encdec.n_audio_frames,
                                cfg.d_model)
    else:
        key, shape = "patches", (batch, cfg.vision.n_patches,
                                 cfg.vision.d_vit)
    return {key: torch.randn(shape, generator=gen, device=gen.device)
            .to(torch.bfloat16)}


def phase_counts(tag: str, launches: dict, want: dict) -> None:
    """Read the counts of the phase just run, hold each of ``want``
    exactly, add them all to ``launches`` and set them to 0."""
    counts = read_counts()
    for name, n in want.items():
        check(counts[name] == n, f"{tag}: {name} was launched "
              f"{counts[name]} times, not {n}")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    say(f"{tag}: launches " + json.dumps(
        {k: v for k, v in counts.items() if v}))
    reset_counts()


def front_serve(lm, prompts: list, inputs: dict, decode: int,
                launches: dict) -> dict:
    """One model-level serving run on the card: each request's prefill
    alone through ``make_prefill_step`` with its frames or patches,
    Whisper's encoder output from ``_encode``, then ``decode`` greedy
    steps of all the requests together through ``make_decode_step`` on
    their caches padded to whole pages and joined; the prefills and the
    steps timed by ``timed_step`` (the last of each profiled).  Each
    phase's launches are held exactly: a prefill runs ``flash_attention``
    once a self-attention, encoder and cross layer; a decode step
    ``paged_attention`` once a layer and ``flash_attention`` once a cross
    layer.  Returns the dict ``serving_cpu_check`` takes."""
    cfg = lm.cfg
    L, P = cfg.n_layers, front_len(cfg)
    n_enc = cfg.encdec.n_enc_layers if cfg.encdec is not None else 0
    n_cross = L if cfg.encdec is not None else 0
    key = "frames" if cfg.encdec is not None else "patches"
    dev = lm.device
    lens = [P + len(p) for p in prompts]
    slots = -(-(max(lens) + decode) // SERVE_PAGE) * SERVE_PAGE
    reset_counts()
    pre = {"host_s": [], "prof": None}
    prefill = timed_step(lambda i: make_prefill_step(lm, lens[i])(
        {"tokens": torch.tensor([prompts[i]], device=dev),
         key: inputs[key][i:i + 1]}), len(prompts), pre)
    logits, caches = [], []
    for i in range(len(prompts)):
        lg, cache = prefill(i)
        logits.append(lg)
        caches.append(_pad_caches(cache, lens[i], slots))
    phase_counts(f"{cfg.name} prefills", launches, {
        "flash_attention": len(prompts) * (L + n_enc + n_cross),
        "paged_attention": 0})
    enc = None
    if n_enc:
        with torch.no_grad():
            enc = lm._encode(inputs[key])
        phase_counts(f"{cfg.name} _encode", launches,
                     {"flash_attention": n_enc})

    def join(parts):
        if isinstance(parts[0], dict):
            return {k: join([p[k] for p in parts]) for k in parts[0]}
        return torch.cat(parts, dim=-4)  # k, v: [L, B, S, Hk, dh]

    joined = join(caches)
    del caches
    dec = {"host_s": [], "prof": None}
    step = timed_step(make_decode_step(lm, with_enc=enc is not None),
                      decode, dec)
    tok = torch.cat([lg.argmax(-1) for lg in logits])
    pos = torch.tensor(lens, device=dev)
    tokens = [tok]
    for _ in range(decode):
        out, joined = step(tok, joined, pos, *(() if enc is None else (enc,)))
        check(bool(torch.isfinite(out.float()).all()), f"{cfg.name}: "
              "non-finite decode logits")
        tok = out.argmax(-1)
        tokens.append(tok)
        pos = pos + 1
    phase_counts(f"{cfg.name} decode", launches, {
        "paged_attention": decode * L, "flash_attention": decode * n_cross})
    tokens = torch.stack(tokens, 1).cpu()
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"{cfg.name}: a token outside the vocabulary")
    pre_dev, pre_k, _ = device_totals(pre["prof"])
    say(f"{cfg.name} prefill, one request a call: " + ", ".join(
        f"{n} positions in {s * 1e3:.3f} ms ({n / s:.1f} tokens/s)"
        for n, s in zip(lens, pre["host_s"]) if s is not None)
        + f" on the host clock (the first includes the shapes' first "
        f"calls); the last, {lens[-1]} positions, profiled: {pre_dev:.3f} "
        f"ms of device time in {pre_k} CUDA kernels, "
        f"{lens[-1] / pre_dev * 1e3:.1f} tokens/s of device time")
    host = [t for t in dec["host_s"][1:] if t is not None]
    host_ms = sum(host) / len(host) * 1e3
    dec_dev, dec_k, _ = device_totals(dec["prof"])
    say(f"{cfg.name} decode, B={len(prompts)}, positions {lens} to "
        f"{[n + decode - 1 for n in lens]}, {slots} slots: {host_ms:.3f} ms "
        f"a step on the host clock (mean of steps 2-{decode - 1}); the "
        f"last profiled: {dec_dev:.3f} ms of device time in {dec_k} CUDA "
        f"kernels; device busy share {dec_dev / host_ms:.4f}; first "
        f"request's tokens {tokens[0, :12].tolist()}")
    return {"cfg": cfg, "lm": lm, "prompts": prompts, "inputs": inputs,
            "slots": slots, "decode_lens": (min(lens), max(lens) + decode - 1)}


def front_train(lm, gen, seed: int, spec: dict, launches: dict) -> dict:
    """``spec["steps"]`` steps of ``make_train_step`` on the card at B =
    ``spec["batch"]``, T = ``spec["seq"]``: tokens from a numpy generator,
    frames or patches from ``gen``, the steps timed by ``timed_step``
    (the last profiled), every loss finite; each step launches
    ``flash_attention`` and ``flash_attention_bwd`` once an attention
    layer (self, encoder and cross), and the decoder's forward again
    under remat (the encoder runs in no region, as in the JAX package);
    peak card memory under ``TRAIN_PEAK_GB``.  Returns the trained
    weights."""
    cfg = lm.cfg
    n_dec = cfg.n_layers * (2 if cfg.encdec is not None else 1)
    n_enc = cfg.encdec.n_enc_layers if cfg.encdec is not None else 0
    n_attn = n_dec + n_enc
    rng = np.random.default_rng(seed + 28)
    timing = {"host_s": [], "prof": None}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_fn = timed_step(make_train_step(lm, cfg.name,
                                         total_steps=spec["steps"]),
                         spec["steps"], timing)
    state = adamw.init(dict(lm.named_parameters()))
    losses = []
    reset_counts()
    for _ in range(spec["steps"]):
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(spec["batch"], spec["seq"] + 1))).to(lm.device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **front_inputs(cfg, gen, spec["batch"])}
        loss, state = step_fn(batch, state)
        losses.append(float(loss))
    phase_counts(f"{cfg.name} training", launches, {
        "flash_attention": spec["steps"] * (
            n_dec * forward_launches(lm.remat) + n_enc),
        "flash_attention_bwd": spec["steps"] * n_attn})
    check(bool(np.isfinite(losses).all()), f"training {cfg.name} gave "
          f"losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < TRAIN_PEAK_GB, f"training {cfg.name}: peak card memory "
          f"{peak:.3f} GB is over {TRAIN_PEAK_GB} GB")
    host_ms = step_times(cfg.name, timing)
    say(f"training {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, remat {lm.remat}): B={spec['batch']}, "
        f"T={spec['seq']}, "
        f"{spec['steps']} steps of make_train_step; losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + "; step times (host clock) "
        + ", ".join("profiled" if t is None else f"{t * 1e3:.3f} ms"
                    for t in timing["host_s"])
        + f"; {host_ms:.3f} ms a step after the first; peak card memory "
        f"{peak:.3f} GB")
    del state
    return {k: t.detach() for k, t in lm.state_dict().items()}


def check_inputs(cfg, seed: int, batch: int) -> dict:
    """A fp32 check's frames or patches: CPU normals from numpy."""
    rng = np.random.default_rng(seed + 29)
    if cfg.encdec is not None:
        return {"frames": torch.from_numpy(rng.normal(size=(
            batch, cfg.encdec.n_audio_frames, cfg.d_model))
            .astype(np.float32))}
    return {"patches": torch.from_numpy(rng.normal(size=(
        batch, cfg.vision.n_patches, cfg.vision.d_vit)).astype(np.float32))}


def whisper_path(seed: int, launches: dict) -> dict:
    """The encoder-decoder path (see ``WHISPER_ARCH``): Whisper-tiny at
    full width and depth on the card, served at model level and trained,
    no plain version on either, each with its fp32 check against the
    CPU.  Adds the launches to ``launches``; returns the serving run's
    dict."""
    t0 = time.perf_counter()
    cfg = get_arch(WHISPER_ARCH)
    lm = LM(cfg, seed=seed)
    check(lm.device.type == "cuda", f"{cfg.name} is not on the card")
    n = sum(p.numel() for p in lm.parameters())
    check(n == WHISPER_PARAMS, f"{cfg.name} holds {n:,} parameters, not "
          f"{WHISPER_PARAMS:,}")
    say(f"{cfg.name} at full width: {cfg.encdec.n_enc_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, vocabulary {cfg.vocab}, "
        f"{cfg.encdec.n_audio_frames} frames; {n:,} parameters, "
        f"{2 * n / 1e9:.3f} GB bf16")
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(seed + 26)
    rng = np.random.default_rng(seed + 26)
    prompts = [rng.integers(1, cfg.vocab, n).tolist()
               for n in WHISPER_PROMPTS]
    with counting_plain() as plain:
        served = front_serve(lm, prompts, front_inputs(cfg, gen, len(prompts)),
                             WHISPER_DECODE, launches)
    check(not any(plain.values()), f"serving {cfg.name}: a plain kernel "
          f"version ran on the path: {plain}")
    serving_cpu_check(served, min)
    with counting_plain() as plain:
        params = front_train(lm, gen, seed, WHISPER_TRAIN, launches)
    check(not any(plain.values()), f"training {cfg.name}: a plain kernel "
          f"version ran on the path: {plain}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    grad_check(f"training {cfg.name} (full width and depth)", cfg, params,
               seed, WHISPER_CHECK_BATCH, WHISPER_TRAIN["seq"],
               check_inputs(cfg, seed, WHISPER_CHECK_BATCH))
    del params
    say(f"{cfg.name} path and its checks: {time.perf_counter() - t0:.3f} s")
    served.pop("inputs")
    return served


def vlm_path(seed: int, launches: dict) -> dict:
    """The VLM path (see ``VLM_ARCH``): InternVL2-76B at full width cut to
    ``VLM_LAYERS`` layers, served at model level on the card with no
    plain version and its fp32 check at ``VLM_CHECK_LAYERS`` layer (the
    served model freed first); then at full width cut to
    ``VLM_TRAIN["layers"]`` layer, trained on the card and its fp32
    check.  Adds the launches to ``launches``; returns the serving run's
    dict."""
    t0 = time.perf_counter()
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, seed=seed)
    check(lm.device.type == "cuda", f"{cfg.name} is not on the card")
    n = sum(p.numel() for p in lm.parameters())
    check(n == VLM_PARAMS, f"{cfg.name} at {VLM_LAYERS} layers holds "
          f"{n:,} parameters, not {VLM_PARAMS:,}")
    say(f"{cfg.name} at full width, {VLM_LAYERS} of {full.n_layers} layers: "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocabulary {cfg.vocab}, {cfg.vision.n_patches} patches of "
        f"{cfg.vision.d_vit}; {n:,} parameters, {2 * n / 1e9:.3f} GB bf16")
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(seed + 27)
    rng = np.random.default_rng(seed + 27)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in VLM_PROMPTS]
    with counting_plain() as plain:
        served = front_serve(lm, prompts, front_inputs(cfg, gen, len(prompts)),
                             VLM_DECODE, launches)
    check(not any(plain.values()), f"serving {cfg.name}: a plain kernel "
          f"version ran on the path: {plain}")
    say(f"{cfg.name}: peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del lm  # served holds it, and the check frees it
    serving_cpu_check(served, min, VLM_CHECK_LAYERS)
    served.pop("inputs")
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(full, n_layers=VLM_TRAIN["layers"])
    lm = LM(tcfg, seed=seed)
    n = sum(p.numel() for p in lm.parameters())
    check(n == VLM_TRAIN_PARAMS, f"{tcfg.name} at {tcfg.n_layers} layer "
          f"holds {n:,} parameters, not {VLM_TRAIN_PARAMS:,}")
    with counting_plain() as plain:
        params = front_train(lm, gen, seed, VLM_TRAIN, launches)
    check(not any(plain.values()), f"training {tcfg.name}: a plain kernel "
          f"version ran on the path: {plain}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    grad_check(f"training {tcfg.name} ({tcfg.n_layers} of {full.n_layers} "
               "layers, full width)", tcfg, params, seed, VLM_CHECK_BATCH,
               VLM_TRAIN["seq"], check_inputs(tcfg, seed, VLM_CHECK_BATCH))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say(f"{cfg.name} path and its checks: {time.perf_counter() - t0:.3f} s")
    return served


def cell_form(variant: str) -> str:
    """The paged kernel's form a variant's decode launches."""
    return "paged_attention int8" if variant == "kv_int8" \
        else "paged_attention"


def cell_bound(cfg, variant: str) -> dict:
    """The dry run's count of the cell (``launch.steps.lower_cell`` on
    meta, ``analysis.roofline.count_costs``) on the one-card mesh: its
    roofline record."""
    variants = frozenset() if variant == "base" else frozenset({variant})
    shape = SHAPES[CELL_SHAPE]
    lowered, _ = steps_mod.lower_cell(cfg, shape, make_smoke_mesh(),
                                      variants=variants)
    costs, _ = roofline.count_costs(lowered.fn, *lowered.args)
    rec = roofline.cell_costs(cfg, shape, costs, [])
    say(f"{cfg.name} {CELL_SHAPE} [{variant}] dry run (meta, H100 spec "
        f"sheet): {rec['gbytes']:.6f} GB, {rec['gflops']:.6f} GFLOP, "
        f"bound {rec['step_time_bound_ms']:.6f} ms ({rec['dominant']}); "
        f"kernels {rec['kernels']}")
    return rec


def random_caches(lm, batch: int, slots: int, gen) -> dict:
    """``lm.init_caches`` filled at random on the card: int8 steps over
    their whole range, or normals."""
    caches = lm.init_caches(batch, slots)
    for leaves in caches.values():
        for group in leaves.values():
            for t in group.values():
                if t.dtype == torch.int8:
                    t.random_(-127, 128, generator=gen)
                else:
                    t.normal_(generator=gen)
    return caches


def event_ms(fn) -> float:
    """Device ms of one call of ``fn``: CUDA events around it (the
    card's timeline from its first kernel to its last, gaps included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def decode_cell(seed: int, launches: dict) -> dict:
    """Qwen2-0.5B's ``decode_32k`` cell at full width and depth (see
    ``CELL_ARCH``): for each of ``CELL_VARIANTS`` the dry run's bound,
    then ``CELL_STEPS`` steps of ``make_decode_step`` counted (exactly
    ``n_layers`` launches of the variant's paged form a step, no other
    kernel and no plain version), logits finite; host ms a step, device
    ms a step (``event_ms``: a step launches some 2,000 kernels, more
    than the launch queue holds, so it cannot be queued behind a sleep),
    the profiler's busy time over two steps, peak card memory; each
    device reading at or above the bound.  Then the fp32
    check of the int8 decode.  Adds the launches to ``launches``."""
    t0 = time.perf_counter()
    cfg = get_arch(CELL_ARCH)
    shape = SHAPES[CELL_SHAPE]
    B, S = shape.global_batch, shape.seq_len
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, seed=seed)
    check(lm.device.type == "cuda", f"{cfg.name} is not on the card")
    dev = lm.device
    n = sum(p.numel() for p in lm.parameters())
    say(f"{cfg.name} {CELL_SHAPE}: B = {B} against {S} slots at pos "
        f"{S - 1}, {cfg.n_layers} layers, {n:,} parameters "
        f"({2 * n / 1e9:.3f} GB bf16)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 29)
    token = torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev)
    pos = torch.full((B,), S - 1, dtype=torch.int64, device=dev)
    step = make_decode_step(lm)
    out = {"cfg": cfg, "variants": {}}
    for variant in CELL_VARIANTS:
        form = cell_form(variant)
        rec = cell_bound(cfg, variant)
        bound_ms = rec["step_time_bound_ms"]
        lm.cache_dtype = torch.int8 if variant == "kv_int8" else None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        caches = random_caches(lm, B, S, gen)
        cache_gb = sum(t.numel() * t.element_size()
                       for leaves in caches.values()
                       for group in leaves.values()
                       for t in group.values()) / 1e9
        host = []
        with counting_plain() as plain:
            reset_counts()
            for _ in range(CELL_STEPS):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                logits, caches = step(token, caches, pos)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - ts) * 1e3)
            counts = read_counts()
        check(not any(plain.values()), f"{cfg.name} {CELL_SHAPE} "
              f"[{variant}]: a plain kernel version ran: {plain}")
        want = CELL_STEPS * cfg.n_layers
        check(counts[form] == want, f"{cfg.name} {CELL_SHAPE} [{variant}]: "
              f"{form} launched {counts[form]} times in {CELL_STEPS} steps, "
              f"not {want}")
        others = {k: v for k, v in counts.items() if v and k != form}
        check(not others, f"{cfg.name} {CELL_SHAPE} [{variant}]: other "
              f"kernels launched: {others}")
        check(tuple(logits.shape) == (B, cfg.vocab)
              and bool(torch.isfinite(logits.float()).all()),
              f"{cfg.name} {CELL_SHAPE} [{variant}]: logits of shape "
              f"{tuple(logits.shape)} or not finite")
        launches[form] += counts[form]
        peak = torch.cuda.max_memory_allocated() / 1e9
        host_ms = min(host[1:])
        dev_ms = min(event_ms(lambda: step(token, caches, pos))
                     for _ in range(2))
        with torch.profiler.profile(activities=CARD_ACTIVITY) as prof:
            for _ in range(2):
                step(token, caches, pos)
            torch.cuda.synchronize()
        busy, n_kernels, kernels = device_totals(prof)
        busy, n_kernels = busy / 2, n_kernels / 2
        top = sorted(kernels, key=lambda e: -e.device_time_total)[:3]
        say(f"{cfg.name} {CELL_SHAPE} [{variant}]: {cache_gb:.3f} GB of "
            f"{str(caches['blocks']['l0']['k'].dtype)[6:]} cache; host "
            f"{host_ms:.3f} ms a step (steps {[round(h, 3) for h in host]})"
            f"; device {dev_ms:.6f} ms a step (events); profiler busy {busy:.6f} ms in {n_kernels:.0f} kernels "
            f"a step, busy share {busy / host_ms:.4f}; bound {bound_ms:.6f}"
            f" ms ({rec['dominant']}), device / bound "
            f"{dev_ms / bound_ms:.4f}; peak card memory {peak:.3f} GB; "
            f"launches {counts[form]} {form}; top kernels: " + "; ".join(
                f"{e.key[:50]} {e.device_time_total / 2e3:.4f} ms"
                for e in top))
        check(dev_ms >= bound_ms, f"{cfg.name} {CELL_SHAPE} [{variant}]: "
              f"device {dev_ms} ms a step is below the dry run's bound "
              f"{bound_ms} ms: the count is wrong")
        check(busy == 0 or busy >= bound_ms, f"{cfg.name} {CELL_SHAPE} "
              f"[{variant}]: profiler busy {busy} ms a step is below the "
              f"dry run's bound {bound_ms} ms: the count is wrong")
        out["variants"][variant] = {
            "host_ms": host_ms, "device_ms": dev_ms, "busy_ms": busy,
            "bound_ms": bound_ms, "cache_gb": cache_gb, "peak_gb": peak,
            "launches": counts[form]}
        del caches, logits
    del step
    cell_fp32_check(lm, seed)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    say(f"{cfg.name} {CELL_SHAPE} cell and its checks: "
        f"{time.perf_counter() - t0:.3f} s")
    return out


# -- the 32 x 8 share ---------------------------------------------------------

def share_key(shape_name: str, variants: tuple) -> str:
    """A share cell's name: its shape, and its variants after it."""
    return " ".join((shape_name,) + variants)


def share_count(cfg, shape_name: str, variants: tuple = ()) -> dict:
    """The dry run's count of one device's share of ``cfg`` x
    ``shape_name`` (under ``variants``) on the 32 x 8 mesh
    (``launch.steps.lower_cell`` on ``meta`` under
    ``launch.mesh.device_mesh``): its roofline record, printed with its
    per-device terms and collective bytes by kind and axis."""
    mesh = make_production_mesh()
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    with device_mesh(mesh, "meta"):
        lowered, _ = steps_mod.lower_cell(cfg, shape, mesh,
                                          variants=frozenset(variants))
        costs, _ = roofline.count_costs(lowered.fn, *lowered.args)
        args_b = dryrun.argument_bytes(lowered.arg_specs, lowered.shardings,
                                       mesh)
    rec = roofline.cell_costs(cfg, shape, costs, [], mesh.size)
    rec["count_s"] = time.perf_counter() - t0
    rec["argument_gb"], rec["temp_gb"] = args_b / 1e9, costs.temp_bytes / 1e9
    t = rec["terms_ms"]
    say(f"{cfg.name} {share_key(shape_name, variants)} on {mesh.name}, one "
        f"device's share (dry run on meta, H100 spec sheet, "
        f"{rec['count_s']:.3f} s): "
        f"argument {rec['argument_gb']:.6f} GB + temp {rec['temp_gb']:.6f} "
        f"GB; {rec['gflops']:.6f} GFLOP, {rec['gbytes']:.6f} GB; compute "
        f"{t['compute']:.6f} ms, memory {t['memory']:.6f} ms, collective "
        f"{t['collective']:.6f} ms; collective MB by kind "
        f"{rec['collective_by_kind_mb']}, by axis "
        f"{rec['collective_by_axis_mb']}; bound "
        f"{rec['step_time_bound_ms']:.6f} ms ({rec['dominant']}); kernels "
        f"{rec['kernels']}")
    return rec


def share_init(cfg, shape, gen):
    """``lower_cell``'s ``make`` for the share on the card: each shard
    drawn where it lives, as ``LM`` draws the whole (bf16 weights normal
    over the square root of their whole fan-in, the embedding's 0.02;
    fp32 norms 1 and biases 0; AdamW's fp32 master copies drawn as their
    parameters, its moments 0), random tokens and labels, normal caches,
    InternVL's patch embeddings normal, and every position at the
    cache's last slot, on ``gen``'s device."""
    dev = gen.device

    def make(name, t, shape_):
        if name == "pos":
            return torch.full(shape_, shape.seq_len - 1, dtype=t.dtype,
                              device=dev)
        if name == "token" or name in ("batch.tokens", "batch.labels"):
            return torch.randint(0, cfg.vocab, shape_, generator=gen,
                                 dtype=t.dtype, device=dev)
        out = torch.empty(shape_, dtype=t.dtype, device=dev)
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("caches.") or name == "batch.patches":
            return out.normal_(generator=gen)
        if name.startswith(("opt.m.", "opt.v.")):  # AdamW's init
            return out.zero_()
        # a parameter, or its fp32 master copy (``opt.master.<name>``)
        if t.dim() == 1:  # norms' weights 1, biases 0
            return out.fill_(1.0 if leaf == "w" else 0.0)
        fan_in = t.shape[-2]
        return out.normal_(generator=gen).mul_(
            0.02 if leaf == "embed" else fan_in ** -0.5)

    return make


def share_heads(cfg, slotted: bool = False) -> tuple:
    """Rank 0's query and kv heads (H, Hk) in a share on the 32 x 8 mesh:
    each over "model" (8), or all of them where the slots are sharded
    over it (``kv_seqshard``)."""
    n = 1 if slotted else make_production_mesh().shape["model"]
    return cfg.n_heads // n, cfg.n_kv_heads // n


def share_launches(cfg, kind: str, remat: str) -> dict:
    """The kernels one step of the share launches, by name: each
    layer's attention once (the train step: its forward again under
    remat, and its backward)."""
    n = cfg.n_layers
    if kind == "decode":
        return {"paged_attention": n}
    if kind == "prefill":
        return {"flash_attention": n}
    return {"flash_attention": n * forward_launches(remat),
            "flash_attention_bwd": n}


def first_layer_keys(caches: dict):
    """Rank 0's first-layer keys [B, S, Hk, dh] of a tree of placed
    caches (a stacked group's leaf holds every layer's)."""
    for v in caches.values():
        if isinstance(v, dict):
            got = first_layer_keys(v)
            if got is not None:
                return got
    if "k" not in caches:
        return None
    k = caches["k"].to_local()
    return k[0] if k.dim() == 5 else k


def share_path(seed: int, launches: dict) -> dict:
    """One H100's share on the 32 x 8 mesh of CodeQwen1.5-7B
    (``SHARE_ARCH``) and of InternVL2-76B's ``train_4k``
    (``VLM_ARCH``): for each of ``SHARE_CELLS`` the dry run's count
    of the share (``share_count``), whose argument plus temp bytes must
    fit the card, then the share run on the card under
    ``device_mesh(mesh, "cuda")`` (the fake group's collectives move
    nothing) through ``lower_cell`` with its shards drawn on the card
    (``share_init``): ``SHARE_STEPS`` steps counted, exactly
    ``share_launches`` a step at the local heads (``share_heads``: H =
    Hk = 4 for CodeQwen1.5-7B, 32 in its slot-sharded decode; H = 8, Hk =
    1 for InternVL2-76B; dh = 128) and no other kernel, no plain
    version; the local logits finite and of the share's shape, or the
    train step's first loss finite (an all-gather over the fake group
    leaves its output as allocated, so the parameters after the first
    update, and the losses after it, are not held); host ms, device ms (``event_ms``) and the
    profiler's busy time a step, which must not be below the count's
    compute and memory bound; the collective term printed beside it as
    what the deployment would add, and the card's peak memory less what
    was held before the share beside the count's argument plus temp
    bytes, which must also fit 80 GB.  The slot-sharded decode
    (``kv_seqshard``) leaves rank 0's cache as it was at pos = 32,767
    (held against a copy of its first layer's keys, whose bytes the
    peak's reading leaves out) and takes one step more at
    ``SEQSHARD_POS``, counted alike, which writes each sequence's slot
    there and nothing else.  Adds the launches to ``launches``; returns,
    by architecture, its config, its cells' readings and its seconds."""
    mesh = make_production_mesh()
    out = {}
    for arch, shape_name, variants in SHARE_CELLS:
        t_shape = time.perf_counter()
        share = out.setdefault(arch, {"cfg": get_arch(arch), "shapes": {},
                                      "seconds": 0.0})
        cfg = share["cfg"]
        key = share_key(shape_name, variants)
        shape = SHAPES[shape_name]
        rec = share_count(cfg, shape_name, variants)
        count_gb = rec["argument_gb"] + rec["temp_gb"]
        check(count_gb < roofline.HBM_BYTES / 1e9, f"{cfg.name} {key} "
              f"share: the count's argument plus temp bytes, {count_gb:.3f} "
              "GB, do not fit the card")
        terms = rec["terms_ms"]
        bound_ms = max(terms["compute"], terms["memory"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9  # earlier paths' leftovers
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 31)
        n_steps = SHARE_STEPS[key]
        with device_mesh(mesh, "cuda"):
            low, lm = steps_mod.lower_cell(cfg, shape, mesh,
                                           variants=frozenset(variants),
                                           make=share_init(cfg, shape, gen))
            n_local = sum(p.to_local().numel() for p in lm.parameters())
            check(lm.embed.to_local().device.type == "cuda",
                  f"{cfg.name} share is not on the card")
            per_step = share_launches(cfg, shape.kind, lm.remat)
            want = {k: n_steps * v for k, v in per_step.items()}
            slotted = "kv_seqshard" in variants
            if slotted:
                k0 = first_layer_keys(low.args[1])
                k_before = k0.clone()
            host = []
            with counting_plain() as plain:
                reset_counts()
                for i in range(n_steps):
                    torch.cuda.synchronize()
                    ts = time.perf_counter()
                    res = low.fn(*low.args)
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - ts) * 1e3)
                    if i == 0:
                        first = res[0]
                        first = (first.to_local() if hasattr(
                            first, "to_local") else first).float()
                counts = read_counts()
            check(not any(plain.values()), f"{cfg.name} {key} share: "
                  f"a plain kernel version ran: {plain}")
            got = {k: counts[k] for k in want}
            check(got == want, f"{cfg.name} {key} share: launches "
                  f"{got} in {n_steps} steps, not {want}")
            others = {k: v for k, v in counts.items() if v and k not in want}
            check(not others, f"{cfg.name} {key} share: other kernels "
                  f"launched: {others}")
            rows = shape.global_batch // mesh.shape["data"]
            if shape.kind == "train":
                check(first.dim() == 0 and bool(torch.isfinite(first)),
                      f"{cfg.name} {key} share: the first step's "
                      f"loss {first} is not a finite scalar")
                what = f"first loss {float(first):.6f}"
            else:
                check(tuple(first.shape) == (rows, cfg.vocab // 8)
                      and bool(torch.isfinite(first).all()),
                      f"{cfg.name} {key} share: local logits of shape "
                      f"{tuple(first.shape)} or not finite")
                what = f"local logits {tuple(first.shape)} finite"
            if slotted:
                check(torch.equal(k0, k_before), f"{cfg.name} {key} share: "
                      f"rank 0 wrote its cache at pos = {shape.seq_len - 1}"
                      ", a slot of another rank's")
            for k, v in got.items():
                launches[k] += v
            del res, first
            dev_ms = min(event_ms(lambda: low.fn(*low.args))
                         for _ in range(2))
            with torch.profiler.profile(activities=CARD_ACTIVITY) as prof:
                low.fn(*low.args)
                torch.cuda.synchronize()
            busy, n_kernels, kernels = device_totals(prof)
            top = sorted(kernels, key=lambda e: -e.device_time_total)[:3]
            peak = torch.cuda.max_memory_allocated() / 1e9
            if slotted:  # less the check's copy of the first layer's keys
                peak -= k_before.numel() * k_before.element_size() / 1e9
                seen, more = seqshard_step(cfg, key, low, per_step, k_before,
                                           launches)
                what += "; " + seen
                got = {k: v + more[k] for k, v in got.items()}
                del k0, k_before
            host_ms = min(host[1:])
            secs = time.perf_counter() - t_shape
            H, Hk = share_heads(cfg, slotted)
            say(f"{cfg.name} {key} share on {mesh.name} (rank 0 of "
                f"{mesh.size}, {n_local:,} parameters of its own, "
                f"{rows} sequences, H = {H}, Hk = {Hk}, dh = "
                f"{cfg.head_dim}" + (f", remat {lm.remat}"
                                     if shape.kind == "train" else "")
                + f"): {what}; host {host_ms:.3f} ms a step (steps "
                f"{[round(h, 3) for h in host]}); device {dev_ms:.6f} ms a "
                f"step (events); profiler busy {busy:.6f} ms in "
                f"{n_kernels} kernels; compute and memory bound "
                f"{bound_ms:.6f} ms, device / bound {dev_ms / bound_ms:.4f}"
                f", busy / bound {busy / bound_ms:.4f}; the collective "
                f"term the deployment would add {terms['collective']:.6f} "
                f"ms; peak card memory {peak:.3f} GB ({held:.3f} GB held "
                f"before the share), {peak - held:.3f} GB the share's, "
                f"against the count's argument + temp {count_gb:.3f} GB "
                f"(count / card {count_gb / (peak - held):.4f}); launches "
                f"{got}; {secs:.3f} s; top kernels: " + "; ".join(
                    f"{e.key[:50]} {e.device_time_total / 1e3:.4f} ms"
                    for e in top))
            check(dev_ms >= bound_ms, f"{cfg.name} {key} share: "
                  f"device {dev_ms} ms a step is below the count's bound "
                  f"{bound_ms} ms: the count is wrong")
            check(busy == 0 or busy >= bound_ms, f"{cfg.name} {key} "
                  f"share: profiler busy {busy} ms a step is below the "
                  f"count's bound {bound_ms} ms: the count is wrong")
            check(peak - held < roofline.HBM_BYTES / 1e9, f"{cfg.name} "
                  f"{key} share: the card's peak less what was held, "
                  f"{peak - held:.3f} GB, does not fit 80 GB")
            share["shapes"][key] = {
                "host_ms": host_ms, "device_ms": dev_ms, "busy_ms": busy,
                "bound_ms": bound_ms, "collective_ms": terms["collective"],
                "launches": got, "peak_gb": peak, "held_gb": held,
                "count_gb": count_gb,
                "count_s": rec["count_s"], "seconds": secs}
            del low, lm
        gc.collect()
        torch.cuda.empty_cache()
        share["seconds"] += time.perf_counter() - t_shape
    for arch, share in out.items():
        say(f"{arch} 32 x 8 share: {share['seconds']:.3f} s")
    return out


def seqshard_step(cfg, key: str, low, per_step: dict, k_before,
                  launches: dict) -> str:
    """The slot-sharded decode's step at ``SEQSHARD_POS`` (every
    sequence's pos set there in place): ``per_step`` launches and no
    plain version, finite local logits, and rank 0's first-layer keys
    changed at that slot of every sequence and nowhere else.  Adds the
    launches to ``launches``; returns what it saw and the launches."""
    low.args[2].to_local().fill_(SEQSHARD_POS)
    k0 = first_layer_keys(low.args[1])
    with counting_plain() as plain:
        reset_counts()
        res = low.fn(*low.args)
        torch.cuda.synchronize()
        counts = read_counts()
    check(not any(plain.values()), f"{cfg.name} {key} share at pos "
          f"{SEQSHARD_POS}: a plain kernel version ran: {plain}")
    got = {k: counts[k] for k in per_step}
    check(got == per_step and not any(
        v for k, v in counts.items() if k not in per_step),
        f"{cfg.name} {key} share at pos {SEQSHARD_POS}: launches {counts}, "
        f"not {per_step}")
    logits = res[0].to_local().float()
    check(bool(torch.isfinite(logits).all()), f"{cfg.name} {key} share at "
          f"pos {SEQSHARD_POS}: local logits not finite")
    moved = (k0 != k_before).any(-1).any(-1)  # [sequence, slot]
    check(bool(moved[:, SEQSHARD_POS].all()) and int(moved.sum())
          == moved.shape[0], f"{cfg.name} {key} share at pos "
          f"{SEQSHARD_POS}: rank 0 changed slots "
          f"{moved.nonzero().tolist()[:8]}, not slot {SEQSHARD_POS} of each "
          "sequence")
    for k, v in got.items():
        launches[k] += v
    return (f"at pos {SEQSHARD_POS} one step more: rank 0 wrote slot "
            f"{SEQSHARD_POS} of each of its {moved.shape[0]} sequences and "
            f"nothing else, launches {got}, local logits finite"), got


def chunked_plain(q, k, v, drop: bool = False) -> torch.Tensor:
    """``attention_plain`` (causal) over ``SHARE_PLAIN_CHUNK`` queries at
    a time, each chunk against the keys up to its last query (the same
    function, in bounded memory); with ``drop`` each query without its
    own key."""
    T, c = q.shape[1], SHARE_PLAIN_CHUNK
    parts = []
    for i in range(0, T, c):
        j = min(T, i + c)
        if not drop:
            parts.append(kflash.attention_plain(q[:, i:j], k[:, :j],
                                                v[:, :j]))
        elif i == 0:
            parts.append(torch.cat([kflash.attention_plain(
                q[:, :1], k[:, :1], v[:, :1]), kflash.attention_plain(
                q[:, 1:j], k[:, :j - 1], v[:, :j - 1])], dim=1))
        else:
            parts.append(kflash.attention_plain(q[:, i:j], k[:, :j - 1],
                                                v[:, :j - 1]))
    return torch.cat(parts, dim=1)


def share_kernels(shares: dict, seed: int) -> dict:
    """Rows 8, 9 and 9b at the shares' local shapes: CodeQwen1.5-7B's (H
    = Hk = 4, dh = 128) paged_attention at decode_32k's (4 sequences of
    32,768 live keys, 2,048 pages each) and flash_attention at
    prefill_32k's (B = 1, T = S = 32,768, causal), and, with
    flash_attention_bwd, each share's train_4k (``share_train_kernels``;
    InternVL2-76B's H = 8, Hk = 1), each within ``ATTN_STEPS`` of its
    plain version (which a dropped newest key breaks), timed beside its
    plain version, ``scaled_dot_product_attention`` on the same inputs
    and its bound.  Returns the ``other_shapes`` entries of each
    kernel's row."""
    share = shares[SHARE_ARCH]
    cfg = share["cfg"]
    H, Hk = share_heads(cfg)
    dh = cfg.head_dim
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 32)
    out = {}
    S = SHAPES["decode_32k"].seq_len
    B = SHAPES["decode_32k"].global_batch // 32
    n_pages = S // SERVE_PAGE
    table = torch.arange(B * n_pages, dtype=torch.int32,
                         device=dev).reshape(B, n_pages)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16)
                     for shape in ((B, H, dh), (B * n_pages, SERVE_PAGE, Hk,
                                                dh),
                                   (B * n_pages, SERVE_PAGE, Hk, dh)))
               for _ in range(4)]
    q, pk, pv = batches[0]
    name = (f"paged_attention ({cfg.name} decode_32k share, B={B}, H={H}, "
            f"Hk={Hk}, dh={dh}, len={S})")
    got = kpaged.paged_mqa(q, pk, pv, table, lens, None)
    torch.cuda.synchronize()
    err = close(name, got, kpaged.paged_attention_plain(
        q, pk, pv, table, lens, None), kpaged.paged_attention_plain(
        q, pk, pv, table, lens - 1, None))
    timed = time_kernel(
        name, lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens, None),
        lambda a, b, c: kpaged.paged_attention_plain(a, b, c, table, lens,
                                                     None),
        batches, reps=64)
    lib = [(a[:, :, None], b.reshape(B, S, Hk, dh).transpose(1, 2),
            c.reshape(B, S, Hk, dh).transpose(1, 2)) for a, b, c in batches]
    lib_ms, lib_call = time_calls(
        lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
            a, b, c), lib, 64)
    bms, by = work_bound(paged_work([S] * B, H, Hk, dh, SERVE_PAGE))
    say(f"{name}: bound {bms:.9f} ms ({by}); scaled_dot_product_attention: "
        f"device {lib_ms} ms, call {lib_call:.6f} ms")
    with_lse = lse_store_cost(name, batches, table, lens)
    out["paged_attention"] = [{
        "max_abs_err": err, "ms": timed["ms"], **plain_of(timed),
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
        "launches": share["shapes"]["decode_32k"]["launches"][
            "paged_attention"], **with_lse,
        "shape": f"{cfg.name} decode_32k on 32x8, rank 0's share: B={B}, "
                 f"H={H}, Hk={Hk}, dh={dh}, len={S}, bf16"}]
    del batches, lib, q, pk, pv, got
    seq_key = share_key("decode_32k", ("kv_seqshard",))
    if seq_key in share["shapes"]:
        out["paged_attention"].append(seqshard_kernel(
            cfg, share["shapes"][seq_key], gen, dev))
        gc.collect()
        torch.cuda.empty_cache()
    if "prefill_32k" in share["shapes"]:
        T = SHAPES["prefill_32k"].seq_len
        batches = [tuple(torch.randn((1, T, h, dh), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for h in (H, Hk, Hk)) for _ in range(2)]
        q, k, v = batches[0]
        name = (f"flash_attention ({cfg.name} prefill_32k share, B=1, T=S={T}"
                f", H={H}, Hk={Hk}, dh={dh}, causal)")
        got = kflash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ferr = close(name, got, chunked_plain(q, k, v),
                     chunked_plain(q, k, v, drop=True))
        ftimed = time_kernel(name, lambda a, b, c: kflash.flash_attention(
            a, b, c), chunked_plain, batches, reps=16)
        flib = [tuple(t.transpose(1, 2) for t in b) for b in batches]
        flib_ms, flib_call = time_calls(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a, b, c, is_causal=True), flib, 16)
        fbms, fby = work_bound(flash_work(1, T, T, H, Hk, dh,
                                          seen_pairs(T, T)))
        say(f"{name}: bound {fbms:.9f} ms ({fby}); "
            f"scaled_dot_product_attention: device {flib_ms} ms, call "
            f"{flib_call:.6f} ms; the plain version in chunks of "
            f"{SHARE_PLAIN_CHUNK} queries")
        out["flash_attention"] = [{
            "max_abs_err": ferr, "ms": ftimed["ms"], **plain_of(ftimed),
            "bound_ms": fbms, "bound_by": fby, "library_ms": flib_ms,
            "launches": share["shapes"]["prefill_32k"]["launches"][
                "flash_attention"],
            "shape": f"{cfg.name} prefill_32k on 32x8, rank 0's share: "
                     f"B=1, T=S={T}, H={H}, Hk={Hk}, dh={dh}, causal, bf16 "
                     f"(plain in chunks of {SHARE_PLAIN_CHUNK} queries)"}]
        del batches, flib, q, k, v, got
    gc.collect()
    torch.cuda.empty_cache()
    for train in shares.values():
        if "train_4k" in train["shapes"]:
            for name, entry in share_train_kernels(train, gen, dev).items():
                out.setdefault(name, []).append(entry)
    return out


def lse_store_cost(name: str, batches, table, lens) -> dict:
    """Row 8 with and without its log-sum-exp at one shape, in turns
    (without, with, with, without), each ``queued_ms`` over 32 calls;
    the outputs bit for bit the same.  Returns the readings."""
    bare = lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens, None)
    lse = lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens, None,
                                           return_lse=True)
    for b in batches:
        check(torch.equal(bare(*b), lse(*b)[0]), f"{name}: the output with "
              "the log-sum-exp differs from the output without it")
    torch.cuda.synchronize()
    turns = [queued_ms(fn, batches, 32, 0.1)[0]
             for fn in (bare, lse, lse, bare)]
    say(f"{name}: the log-sum-exp's store: without {turns[0]:.6f}, with "
        f"{turns[1]:.6f}, with {turns[2]:.6f}, without {turns[3]:.6f} ms "
        "a call (queued, 32 calls each); outputs bit for bit equal")
    return {"ms_without_lse": [turns[0], turns[3]],
            "ms_with_lse": [turns[1], turns[2]]}


def paged_lse_close(name: str, lse, plain) -> float:
    """Row 8's log-sum-exp within ``LSE_TOL`` of max(1, |plain|), -inf
    on exactly the rows where no key is live; the largest gap."""
    live = torch.isfinite(plain)
    check(torch.equal(torch.isfinite(lse), live)
          and bool((lse[~live] < 0).all()) and not bool(lse.isnan().any()),
          f"{name}: the log-sum-exp is not -inf on exactly the rows that "
          "see no key")
    gap = float(((lse - plain).abs() / plain.abs().clamp_min(1.0))[live]
                .max()) if bool(live.any()) else 0.0
    check(gap <= LSE_TOL, f"{name}: the log-sum-exp differs from the plain "
          f"version's by {gap:.3e} of max(1, |plain|)")
    return gap


def seqshard_kernel(cfg, timing: dict, gen, dev) -> dict:
    """Row 8 with its log-sum-exp at the slot-sharded decode's shape:
    rank 0's 4 sequences over its 4,096 slots (256 pages of 16) of all
    32 kv heads, H = Hk = 32, dh = 128, bf16, each length 32,768 as the
    share's step passes it (past the shard's table: every slot live).
    The output within ``ATTN_STEPS`` of the plain version (which the
    shard's newest key dropped breaks), the log-sum-exp within
    ``LSE_TOL``; timed beside the plain version, SDPA over the same keys
    and ``aten._scaled_dot_product_flash_attention``, which also returns
    its log-sum-exp (the library call); its bound; then the edge inputs
    (``seqshard_edges``).  Returns the row's entry."""
    H = Hk = cfg.n_heads
    dh = cfg.head_dim
    B = SHAPES["decode_32k"].global_batch // 32
    S = SHAPES["decode_32k"].seq_len // 8
    n_pages = S // SERVE_PAGE
    table = torch.arange(B * n_pages, dtype=torch.int32,
                         device=dev).reshape(B, n_pages)
    lens = torch.full((B,), SHAPES["decode_32k"].seq_len, dtype=torch.int32,
                      device=dev)
    batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16)
                     for shape in ((B, H, dh), (B * n_pages, SERVE_PAGE, Hk,
                                                dh),
                                   (B * n_pages, SERVE_PAGE, Hk, dh)))
               for _ in range(4)]
    q, pk, pv = batches[0]
    name = (f"paged_attention ({cfg.name} decode_32k kv_seqshard share, "
            f"B={B}, H={H}, Hk={Hk}, dh={dh}, {S} slots, with LSE)")
    got, lse = kpaged.paged_mqa(q, pk, pv, table, lens, None,
                                return_lse=True)
    torch.cuda.synchronize()
    plain, plain_lse = kpaged.paged_attention_plain(
        q, pk, pv, table, lens, None, return_lse=True)
    err = close(name, got, plain, kpaged.paged_attention_plain(
        q, pk, pv, table, torch.full_like(lens, S - 1), None),
        "the shard's newest key dropped")
    gap = paged_lse_close(name, lse, plain_lse)
    del got, lse, plain, plain_lse
    timed = time_kernel(
        name, lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens, None,
                                               return_lse=True),
        lambda a, b, c: kpaged.paged_attention_plain(
            a, b, c, table, lens, None, return_lse=True), batches, reps=64)
    lib = [(a[:, :, None], b.reshape(B, S, Hk, dh).transpose(1, 2),
            c.reshape(B, S, Hk, dh).transpose(1, 2)) for a, b, c in batches]
    sdpa_ms, sdpa_call = time_calls(
        lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
            a, b, c), lib, 64)
    lib_ms, lib_call = time_calls(
        lambda a, b, c: torch.ops.aten._scaled_dot_product_flash_attention(
            a, b, c), lib, 64)
    bms, by = work_bound(paged_work([S] * B, H, Hk, dh, SERVE_PAGE,
                                    lse=True))
    say(f"{name}: LSE within {gap:.3e} of max(1, |plain|); bound "
        f"{bms:.9f} ms ({by}); scaled_dot_product_attention: device "
        f"{sdpa_ms} ms, call {sdpa_call:.6f} ms; aten._scaled_dot_product_"
        f"flash_attention (with its LSE): device {lib_ms} ms, call "
        f"{lib_call:.6f} ms")
    del batches, lib, q, pk, pv
    edges = seqshard_edges(dev)
    return {"max_abs_err": err, "ms": timed["ms"], **plain_of(timed),
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "sdpa_ms": sdpa_ms, "lse_gap": gap, "edges": edges,
            "launches": timing["launches"]["paged_attention"],
            "shape": f"{cfg.name} decode_32k kv_seqshard on 32x8, rank 0's "
                     f"share: B={B}, H={H}, Hk={Hk}, dh={dh}, {S} slots, "
                     "len 32768, bf16, with LSE"}


def seqshard_edges(dev) -> int:
    """Row 8's log-sum-exp at the edges a slot shard meets, at H = Hk =
    32, dh = 128: for fp32, bf16 and int8 pages over a 256-slot shard,
    lengths 0, -100 (the new key on an earlier shard), 1, 300 and 1,000
    (past the shard) without a window and with one of 64 (1,000 - 64
    lies past the shard: wholly behind the window); out and LSE against
    the plain version (``ATTN_TOL``-like: ``attn_limit``; ``LSE_TOL``),
    zeros and -inf where no key is live, no NaN; then a 32,768-slot
    cache cut into 8 shards of 4,096, each through the kernel with its
    own length and merged by LSE (``attention.merge_by_lse``), against
    the kernel over the whole cache, fp32 within ``FP32_TOL`` of the
    largest output and bf16 within 2^-7 of it, without a window and
    with one of 4,096 across the shards' borders.  Returns the number
    of calls checked."""
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    B, H, dh, S, PS = 5, 32, 128, 256, SERVE_PAGE
    lens = torch.tensor([0, -100, 1, 300, 1000], dtype=torch.int32,
                        device=dev)
    table = torch.arange(B * S // PS, dtype=torch.int32,
                         device=dev).reshape(B, S // PS)
    n = 0
    for kind, (qdt, scale) in {"fp32": (torch.float32, None),
                               "bf16": (torch.bfloat16, None),
                               "int8": (torch.bfloat16, 1 / 32)}.items():
        q = torch.randn((B, H, dh), generator=gen, device=dev).to(qdt)
        if scale is None:
            pk, pv = (torch.randn((B * S // PS, PS, H, dh), generator=gen,
                                  device=dev).to(qdt) for _ in range(2))
        else:
            pk, pv = (torch.randint(-127, 128, (B * S // PS, PS, H, dh),
                                    generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
        for window in (None, 64):
            name = f"paged_attention edges ({kind} pages, window {window})"
            out, lse = kpaged.paged_mqa(q, pk, pv, table, lens, window,
                                        kv_scale=scale, return_lse=True)
            torch.cuda.synchronize()
            p_out, p_lse = kpaged.paged_attention_plain(
                q, pk, pv, table, lens, window, kv_scale=scale,
                return_lse=True)
            paged_lse_close(name, lse, p_lse)
            dead = ~torch.isfinite(p_lse).all(-1)
            want = [True, True, False, False, window is not None]
            check(dead.tolist() == want, f"{name}: sequences without a live "
                  f"key {dead.tolist()}, not {want}")
            check(not bool(out.float().isnan().any()) and torch.equal(
                out[dead], torch.zeros_like(out[dead])), f"{name}: a "
                "sequence without a live key is not zeros, or a NaN")
            diff = (out.float() - p_out.float()).abs()
            check(bool((diff <= attn_limit(p_out)).all()), f"{name}: kernel "
                  f"differs from its plain version by "
                  f"{float((diff / attn_limit(p_out)).max())} of the limit")
            n += 1
    B, S = 4, SHAPES["decode_32k"].seq_len
    w = S // 8
    pos = torch.tensor([5, w - 1, w, S - 1], device=dev)
    table = attn_mod.identity_pages(B, S, PS, dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
        ck, cv = (torch.randn((B, S, H, dh), generator=gen, device=dev)
                  .to(dtype) for _ in range(2))
        for window in (None, 4096):
            parts = [attn_mod.attend_slot_shard(
                q, ck[:, i * w:(i + 1) * w].contiguous(),
                cv[:, i * w:(i + 1) * w].contiguous(),
                (pos + 1 - i * w).int(), window) for i in range(8)]
            got = attn_mod.merge_by_lse(
                torch.stack([o for o, _ in parts]),
                torch.stack([l for _, l in parts]),
                lambda t: t.amax(0, keepdim=True),
                lambda t: t.sum(0, keepdim=True))[0]
            whole = kpaged.paged_mqa(q, ck.reshape(-1, PS, H, dh),
                                     cv.reshape(-1, PS, H, dh), table,
                                     (pos + 1).int(), window).float()
            torch.cuda.synchronize()
            err = float((got - whole).abs().max())
            limit = (FP32_TOL if dtype == torch.float32 else 2.0 ** -7) \
                * float(whole.abs().max())
            check(not bool(got.isnan().any()) and err <= limit,
                  f"8 slot shards merged by LSE ({dtype}, window {window}) "
                  f"differ from the unsharded kernel by {err} (limit "
                  f"{limit})")
            say(f"8 slot shards of {w} merged by LSE ({dtype}, window "
                f"{window}): within {err:.3e} of the unsharded kernel "
                f"(limit {limit:.3e})")
            n += 1
            del parts, got, whole
        del ck, cv
    say(f"paged_attention's edges at H = Hk = {H}: {n} calls checked")
    return n


def share_train_kernels(share: dict, gen, dev) -> dict:
    """Rows 9 and 9b at a train_4k share's local shape (B = 8 sequences,
    T = S = 4,096, the share's heads, dh = 128, causal, bf16): the
    forward with its log-sum-exp, as the train step calls it, within
    ``ATTN_STEPS`` of ``chunked_plain`` (a dropped newest key breaking
    it) and its LSE within ``LSE_TOL``; the backward's dq, dk, dv each
    within ``attn_limit`` of ``attention_bwd_plain`` (which the plain
    version without the D term breaks); each timed beside its plain
    version, SDPA's forward or autograd backward (kv heads repeated
    beforehand) and its bound.  Returns each row's entry."""
    cfg = share["cfg"]
    H, Hk = share_heads(cfg)
    dh = cfg.head_dim
    shape = SHAPES["train_4k"]
    T, B = shape.seq_len, shape.global_batch // 32
    seq = f"B={B}, T=S={T}, H={H}, Hk={Hk}, dh={dh}, causal, bf16"
    launches = share["shapes"]["train_4k"]["launches"]
    batches = []
    for _ in range(2):
        q, k, v, dout = (torch.randn((B, T, h, dh), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for h in (H, Hk, Hk, H))
        o, lse = kflash.flash_attention(q, k, v, return_lse=True)
        batches.append((q, k, v, o, dout, lse))
    q, k, v, o, dout, lse = batches[0]
    torch.cuda.synchronize()
    name = f"flash_attention ({cfg.name} train_4k share, {seq}, with LSE)"
    plain_o, plain_lse = kflash.attention_plain(q, k, v, return_lse=True)
    gap = lse_close(name, lse, plain_lse)
    del plain_o, plain_lse
    ferr = close(name, o, chunked_plain(q, k, v),
                 chunked_plain(q, k, v, drop=True))
    ftimed = time_kernel(name, lambda a, b, c, *_: kflash.flash_attention(
        a, b, c, return_lse=True), lambda a, b, c, *_: chunked_plain(a, b, c),
        batches, reps=16)
    flib = [(b[0].transpose(1, 2),) + tuple(
        t.repeat_interleave(H // Hk, dim=2).transpose(1, 2) for t in b[1:3])
        for b in batches]  # kv heads repeated, as sdpa_bwd's
    flib_ms, flib_call = time_calls(
        lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
            a, b, c, is_causal=True), flib, 16)
    pairs = seen_pairs(T, T)
    fbms, fby = work_bound(flash_work(B, T, T, H, Hk, dh, pairs, lse=True))
    say(f"{name}: LSE within {gap:.3e} of max(1, |plain|); bound "
        f"{fbms:.9f} ms ({fby}); scaled_dot_product_attention: device "
        f"{flib_ms} ms, call {flib_call:.6f} ms")
    del flib
    bname = f"flash_attention_bwd ({cfg.name} train_4k share, {seq})"
    got = kflash.flash_attention_bwd(q, k, v, o, dout, lse=lse)
    plain = kflash.attention_bwd_plain(q, k, v, o, dout)
    no_d = kflash.attention_bwd_plain(q, k, v, torch.zeros_like(o), dout)
    berr, shares, caught = 0.0, [], 0
    for part, g, p, b in zip(("dq", "dk", "dv"), got, plain, no_d):
        limit = attn_limit(p)
        diff = (g.float() - p.float()).abs()
        check(bool(torch.isfinite(g.float()).all()), f"{bname} {part}: "
              "non-finite output")
        check(bool((diff <= limit).all()), f"{bname} {part}: kernel differs "
              f"from its plain version by up to "
              f"{float((diff / limit).max())} times the limit")
        caught += int(((b.float() - p.float()).abs() > limit).sum())
        berr = max(berr, float(diff.max()))
        shares.append(float((diff / limit).max()))
    check(caught > 0, f"{bname}: the limit does not see the plain version "
          "without the D term")
    say(f"{bname}: dq, dk, dv within {max(shares):.4f} of the limit of "
        f"{ATTN_STEPS} bf16 unit roundoffs (max abs err {berr:.6g}); the "
        f"plain version without the D term breaks it at {caught} elements")
    del got, plain, no_d
    btimed = time_kernel(
        bname, lambda a, b, c, oo, d, ll: kflash.flash_attention_bwd(
            a, b, c, oo, d, lse=ll),
        lambda a, b, c, oo, d, ll: kflash.attention_bwd_plain(
            a, b, c, oo, d), batches, reps=16)
    blib_ms, blib_call = sdpa_bwd(batches, H, Hk, None, 16)
    bbms, bby = work_bound(flash_bwd_work(B, T, T, H, Hk, dh, pairs))
    say(f"{bname}: bound {bbms:.9f} ms ({bby}); scaled_dot_product_"
        f"attention's backward: device {blib_ms} ms, call "
        f"{blib_call:.6f} ms")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    where = f"{cfg.name} train_4k on 32x8, rank 0's share: {seq}"
    return {"flash_attention": {
                "max_abs_err": ferr, "ms": ftimed["ms"], **plain_of(ftimed),
                "bound_ms": fbms, "bound_by": fby, "library_ms": flib_ms,
                "launches": launches["flash_attention"],
                "shape": where + f", with LSE (plain in chunks of "
                                 f"{SHARE_PLAIN_CHUNK} queries)"},
            "flash_attention_bwd": {
                "max_abs_err": berr, "ms": btimed["ms"], **plain_of(btimed),
                "bound_ms": bbms, "bound_by": bby, "library_ms": blib_ms,
                "launches": launches["flash_attention_bwd"],
                "shape": where, "limit_share": max(shares)}}


def cell_fp32_check(lm, seed: int) -> None:
    """One int8-cache decode step at B = ``CELL_CHECK_BATCH`` over
    ``CELL_CHECK_SLOTS`` slots with ``lm``'s weights upcast to fp32
    (exactly) on the card and on the CPU: the same random int8 cache and
    tokens, positions at the cache's end and inside it; logits within
    ``FP32_TOL`` of the largest; the int8 slots the step wrote within one
    quantization step of the CPU's (fp32 products in another order may
    round a value at a half step the other way); exactly ``n_layers``
    int8 launches on the card."""
    cfg = lm.cfg
    sd = {k: t.detach().float() for k, t in lm.state_dict().items()}
    card = LM(cfg, device="meta")
    card.load_state_dict(sd, assign=True)
    cpu = LM(cfg, device="meta")
    cpu.load_state_dict({k: t.cpu() for k, t in sd.items()}, assign=True)
    del sd
    B, S = CELL_CHECK_BATCH, CELL_CHECK_SLOTS
    rng = np.random.default_rng(seed + 29)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, B))
    pos = torch.tensor([S - 1, S // 3])
    got = []
    for m in (card, cpu):
        m.cache_dtype = torch.int8
        caches = m.init_caches(B, S)
        fill = np.random.default_rng(seed + 30).integers(
            -127, 128, tuple(caches["blocks"]["l0"]["k"].shape)).astype(
            np.int8)
        for name in ("k", "v"):
            caches["blocks"]["l0"][name].copy_(torch.from_numpy(fill))
        reset_counts()
        logits, caches = m.decode_step(token.to(m.device), caches,
                                       pos.to(m.device))
        counts = read_counts()
        got.append((logits.float().cpu(), {
            k: caches["blocks"]["l0"][k].cpu() for k in ("k", "v")},
            counts))
    (lc, cc, counts), (lp, cp, _) = got
    check(counts["paged_attention int8"] == cfg.n_layers,
          f"the fp32 int8 check launched {counts['paged_attention int8']} "
          f"int8 paged kernels, not {cfg.n_layers}")
    err = float((lc - lp).abs().max())
    ref = float(lp.abs().max())
    check(bool(torch.isfinite(lc).all()) and err <= FP32_TOL * ref,
          f"{cfg.name} int8 decode fp32: card differs from the CPU by {err}"
          f" ({err / ref:.3e} of the largest logit {ref})")
    steps_off = max(int((cc[k].int() - cp[k].int()).abs().max())
                    for k in ("k", "v"))
    flips = sum(int((cc[k] != cp[k]).sum()) for k in ("k", "v"))
    check(steps_off <= 1, f"{cfg.name} int8 decode fp32: a written slot "
          f"differs from the CPU's by {steps_off} int8 steps")
    say(f"{cfg.name} int8 decode fp32 (B = {B}, {S} slots, pos "
        f"{pos.tolist()}): logits within {err / ref:.3e} of the largest "
        f"({ref:.4f}) of the CPU's, limit {FP32_TOL}; {flips} int8 slot "
        f"values one step off the CPU's")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()


def paged_int8_vs_plain(cell: dict, seed: int, launches: dict) -> list:
    """paged_attention over int8 pages at the decode_32k cell's shape
    (B = 128, Qwen2-0.5B's heads, 2,048 pages of 16 slots a sequence, every
    key live): within ``ATTN_STEPS`` of the plain version (which
    dequantizes as the JAX package does), which the plain version at a
    scale of 1/16 breaks; timed beside the plain version and the bf16
    pages' kernel at the same shape (its pages the int8 ones' values).
    No single op reads int8 pages: no library call."""
    cfg = cell["cfg"]
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shape = SHAPES[CELL_SHAPE]
    B, S = shape.global_batch, shape.seq_len
    n_pages = S // SERVE_PAGE
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    table = torch.arange(B * n_pages, dtype=torch.int32,
                         device=dev).reshape(B, n_pages)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    scale = 1.0 / KV_QSCALE

    def draw():
        q = torch.randn((B, H, dh), generator=gen, device=dev) \
            .to(torch.bfloat16)
        pk, pv = (torch.empty((B * n_pages, SERVE_PAGE, Hk, dh),
                              dtype=torch.int8, device=dev)
                  .random_(-127, 128, generator=gen) for _ in range(2))
        return q, pk, pv

    batches = [draw() for _ in range(2)]
    q, pk, pv = batches[0]
    got = kpaged.paged_mqa(q, pk, pv, table, lens, kv_scale=scale)
    torch.cuda.synchronize()
    plain = kpaged.paged_attention_plain(q, pk, pv, table, lens,
                                         kv_scale=scale)
    broken = kpaged.paged_attention_plain(q, pk, pv, table, lens,
                                          kv_scale=2 * scale)
    name = (f"paged_attention int8 ({cfg.name} {CELL_SHAPE}, B={B}, "
            f"len={S})")
    err = close(name, got, plain, broken, "a scale of 1/16")
    del plain, broken
    timed = time_kernel(
        name, lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens,
                                               kv_scale=scale),
        lambda a, b, c: kpaged.paged_attention_plain(a, b, c, table, lens,
                                                     kv_scale=scale),
        batches, reps=64)
    work = paged_work([S] * B, H, Hk, dh, SERVE_PAGE, 2, 1)
    bms, by = work_bound(work)
    # the bf16 pages' kernel at the same shape and values
    bf = [(a, b.to(torch.bfloat16) * scale, c.to(torch.bfloat16) * scale)
          for a, b, c in batches[:1]]
    del batches
    bf_ms, bf_call = time_calls(
        lambda a, b, c: kpaged.paged_mqa(a, b, c, table, lens), bf, 64)
    bf_bms, bf_by = work_bound(paged_work([S] * B, H, Hk, dh, SERVE_PAGE))
    say(f"{name}: bound {bms:.9f} ms ({by}, {work.bytes:.0f} bytes); the "
        f"bf16 pages' kernel at the same shape: device {bf_ms} ms, call "
        f"{bf_call:.6f} ms, bound {bf_bms:.9f} ms ({bf_by}); library call: "
        "none, no single op reads int8 pages")
    del bf
    gc.collect()
    torch.cuda.empty_cache()
    variants = cell["variants"]
    say(f"paged_attention int8: main-path launches "
        f"{launches['paged_attention int8']}")
    out = row("paged_attention int8", launches, err, timed, bms, by, None,
              f"{cfg.name} {CELL_SHAPE}, B={B}, H={H}, Hk={Hk}, dh={dh}, "
              f"len={S}, int8 pages, bf16 q")
    out["bf16_pages"] = {"ms": bf_ms, "bound_ms": bf_bms, "bound_by": bf_by}
    out["cell_steps"] = {v: {k: r[k] for k in ("host_ms", "device_ms",
                                               "busy_ms", "bound_ms")}
                         for v, r in variants.items()}
    return [out]


# the WKV6 backward's cases: RWKV6-7B's training shape in bf16 (the main
# path's) and fp32 (the card-vs-CPU check's), then a ragged T with a
# carried state, the final state's gradient and strong decays, T = 1, and
# the chunked form's edges (a chunk of 64 one short, one over, two and
# one over) with a carried state
WKV_BWD_CASES = (
    ("RWKV6-7B training", 8, 256, 64, 64, torch.bfloat16, -8.0, False),
    ("RWKV6-7B training", 8, 256, 64, 64, torch.float32, -8.0, False),
    ("ragged T, carried state, strong decay", 2, 77, 64, 64,
     torch.bfloat16, -20.0, True),
    ("T=1, carried state", 8, 1, 64, 64, torch.float32, -8.0, True),
    ("T=63, carried state", 2, 63, 64, 64, torch.bfloat16, -8.0, True),
    ("T=65, carried state", 2, 65, 64, 64, torch.bfloat16, -20.0, True),
    ("T=129, carried state", 2, 129, 64, 64, torch.bfloat16, -8.0, True))


def wkv6_bwd_vs_plain(seed: int, launches: dict) -> list:
    """wkv6_bwd against ``wkv6_bwd_plain`` at ``WKV_BWD_CASES`` within
    ``grads_close``'s limits, which the plain version with the first and
    last steps' do dropped (and, with a carried state, without the final
    state's gradient) breaks on every output; two calls bit-identical;
    the first case timed beside the plain version.  Bound: the bytes of
    r, k, v, do, dr, dk, dv (bf16), logw and dlogw (fp32) over HBM
    bandwidth against the chunked form's products (``wkv_bwd_flops``) at
    the bf16 tensor-core rate; the serial form's 12 FLOPs a state element
    a step at the fp32 rate printed beside it.  No single op computes a
    scan's gradient: no library call."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 26)
    err, out = 0.0, None
    for what, B, T, H, dh, dtype, logw_lo, carried in WKV_BWD_CASES:
        name = (f"wkv6_bwd ({what}, B={B}, T={T}, H={H}, dh={dh}, "
                f"{str(dtype)[6:]})")
        draws = [wkv_bwd_draw(gen, B, T, H, dh, dtype, logw_lo, carried)
                 for _ in range(2)]
        r, k, v, logw, u, do, state, dstate = draws[0]
        got = kwkv.wkv6_bwd(*draws[0])
        again = kwkv.wkv6_bwd(*draws[0])
        torch.cuda.synchronize()
        plain = kwkv.wkv6_bwd_plain(*draws[0])
        broken = kwkv.wkv6_bwd_plain(r, k, v, logw, u, ends_dropped(do),
                                     state)
        variant = ("the plain version with the first and last steps' do "
                   "dropped" + (" and without the final state's gradient"
                                if carried else ""))
        err = max(err, grads_close(
            name, ("dr", "dk", "dv", "dlogw", "du", "dstate"), got, again,
            plain, broken, variant))
        del got, again, plain, broken
        if out is None:
            # the main path's form: the states entering each chunk from
            # the forward's scratch, as wkv6_heads passes them, the same
            # bits as when the backward recomputes them
            kept = [kwkv.wkv6(*d[:5], d[6], keep_states=True)[1:]
                    for d in draws]
            again = kwkv.wkv6_bwd(*draws[0], saved=kept[0][1],
                                  final=kept[0][0])
            check(all((a is None and b is None) or torch.equal(a, b)
                      for a, b in zip(again, kwkv.wkv6_bwd(*draws[0]))),
                  f"{name}: the backward from the forward's chunk states "
                  "differs from the one that recomputes them")
            say(f"{name}: from the forward's chunk states bit-identical")
            del again
            timed = time_kernel(
                name, lambda *a: kwkv.wkv6_bwd(*a[:8], saved=a[9],
                                               final=a[8]),
                lambda *a: kwkv.wkv6_bwd_plain(*a[:8]),
                [d + k for d, k in zip(draws, kept)], reps=16)
            dev_ms, call_ms = time_calls(lambda *a: kwkv.wkv6_bwd(*a), draws,
                                         16)
            timed["recompute_ms"] = dev_ms
            say(f"{name}, recomputing the chunk states: device {dev_ms} ms, "
                f"call {call_ms:.6f} ms per launch")
            del kept
            work = wkv6_bwd_work(B, T, H, dh, r.element_size())
            n_bytes = work.bytes
            bms, by = work_bound(work)
            lane_ms, _ = bound(n_bytes, 12 * dh * dh * T * H * B)
            scratch = kwkv.kernel._bwd_library().wkv6_bwd_scratch_floats(
                B, T, H, dh, kwkv.kernel.DTYPES[dtype]) * 4
            say(f"{name}: bound {bms:.9f} ms ({by}, {n_bytes} bytes; "
                f"the serial form's fp32-lane bound {lane_ms:.9f} ms); "
                f"scratch {scratch / 1e6:.3f} MB a call; library call: "
                "none, no single op computes a scan's gradient")
            out = (timed, bms, by, f"{what}, B={B}, T={T}, H={H}, dh={dh}, "
                   "bf16")
        del draws
    timed, bms, by, shape = out
    say(f"wkv6_bwd: main-path launches {launches['wkv6_bwd']}")
    return [dict(row("wkv6_bwd", launches, err, timed, bms, by, None, shape),
                 recompute_ms=timed["recompute_ms"])]


# the SSD backward's cases: Jamba-1.5-Large's full-width mixer shape (the
# ssd row's) in bf16 and fp32, then a ragged T with a carried state, the
# final state's gradient and strong decays (dt A down to -12), T = 1, the
# hybrid's reduced() shapes (dh = 32, N = 8: another build of the
# kernel): its training step's in bf16, from a carried state too, and
# its fp32 check's (B = 2, T = 72), and the chunked form's edges (a chunk
# of 64 one short, one over, two and one over) with a carried state
SSD_BWD_CASES = (
    ("Jamba-1.5-Large Mamba mixer", 1, 4096, 256, 64, 16, torch.bfloat16,
     0.4, False),
    ("Jamba-1.5-Large Mamba mixer", 1, 4096, 256, 64, 16, torch.float32,
     0.4, False),
    ("ragged T, carried state, strong decay", 2, 1001, 256, 64, 16,
     torch.bfloat16, 8.0, True),
    ("T=1, carried state", 2, 1, 256, 64, 16, torch.float32, 0.4, True),
    ("hybrid reduced() training", 8, 64, 8, 32, 8, torch.bfloat16, 0.4,
     False),
    ("hybrid reduced() training, carried state", 8, 64, 8, 32, 8,
     torch.bfloat16, 0.4, True),
    ("hybrid reduced() fp32 check, carried state", 2, 72, 8, 32, 8,
     torch.float32, 0.4, True),
    ("T=63, carried state", 2, 63, 256, 64, 16, torch.bfloat16, 0.4, True),
    ("T=65, carried state", 2, 65, 256, 64, 16, torch.bfloat16, 8.0, True),
    ("T=129, carried state", 2, 129, 256, 64, 16, torch.bfloat16, 0.4,
     True))


def ssd_bwd_vs_plain(seed: int, launches: dict) -> list:
    """ssd_bwd against ``ssd_bwd_plain`` at ``SSD_BWD_CASES`` within
    ``grads_close``'s limits, which the plain version with the first and
    last steps' dy dropped (and, with a carried state, without the final
    state's gradient) breaks on every output; two calls bit-identical;
    the first case timed beside the plain version, and the hybrid's
    reduced() training case, where its main-path launches are, timed
    alone (``reduced_ms``).  Bound: the bytes of x, dy, dx (bf16), dt and
    ddt (fp32), B_, C_, dB_, dC_ (bf16) and A, dA over HBM bandwidth
    against the chunked form's products (``ssd_bwd_flops``) at the bf16
    tensor-core rate; the serial form's 12 FLOPs a state element a step
    at the fp32 rate printed beside it.  No single op computes a scan's
    gradient: no library call."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 27)
    err, out, reduced_ms = 0.0, None, None
    for what, B, T, H, dh, N, dtype, dt_hi, carried in SSD_BWD_CASES:
        name = (f"ssd_bwd ({what}, B={B}, T={T}, H={H}, dh={dh}, N={N}, "
                f"{str(dtype)[6:]})")
        timed_here = out is None or (what == "hybrid reduced() training")
        draws = [ssd_bwd_draw(gen, B, T, H, dh, N, dtype, dt_hi, carried)
                 for _ in range(2 if timed_here else 1)]
        x, dt, Bm, Cm, A, dy, state, dstate = draws[0]
        got = kssd.ssd_bwd(*draws[0])
        again = kssd.ssd_bwd(*draws[0])
        torch.cuda.synchronize()
        plain = kssd.ssd_bwd_plain(*draws[0])
        broken = kssd.ssd_bwd_plain(x, dt, Bm, Cm, A, ends_dropped(dy),
                                    state)
        variant = ("the plain version with the first and last steps' dy "
                   "dropped" + (" and without the final state's gradient"
                                if carried else ""))
        err = max(err, grads_close(
            name, ("dx", "ddt", "dB_", "dC_", "dA", "dstate"), got, again,
            plain, broken, variant))
        del got, again, plain, broken
        if timed_here:
            # the main path's form: the states entering each chunk from
            # the forward's scratch, as ssd_heads passes them, the same
            # bits as when the backward recomputes them
            kept = [kssd.ssd(*d[:5], d[6], keep_states=True)[2:]
                    for d in draws]
            again = kssd.ssd_bwd(*draws[0], saved=kept[0][0])
            check(all((a is None and b is None) or torch.equal(a, b)
                      for a, b in zip(again, kssd.ssd_bwd(*draws[0]))),
                  f"{name}: the backward from the forward's chunk states "
                  "differs from the one that recomputes them")
            say(f"{name}: from the forward's chunk states bit-identical")
            del again
            with_states = [d + k for d, k in zip(draws, kept)]
        if out is None:
            timed = time_kernel(
                name, lambda *a: kssd.ssd_bwd(*a[:8], saved=a[8]),
                lambda *a: kssd.ssd_bwd_plain(*a[:8]), with_states, reps=16)
            dev_ms, call_ms = time_calls(lambda *a: kssd.ssd_bwd(*a), draws,
                                         16)
            timed["recompute_ms"] = dev_ms
            say(f"{name}, recomputing the chunk states: device {dev_ms} ms, "
                f"call {call_ms:.6f} ms per launch")
            work = ssd_bwd_work(B, T, H, dh, N, x.element_size())
            n_bytes = work.bytes
            bms, by = work_bound(work)
            lane_ms, _ = bound(n_bytes, 12 * dh * N * T * H * B)
            scratch = kssd.kernel._bwd_library().ssd_bwd_scratch_floats(
                B, T, H, dh, N, kssd.kernel.DTYPES[dtype]) * 4
            say(f"{name}: bound {bms:.9f} ms ({by}, {n_bytes} bytes; "
                f"the serial form's fp32-lane bound {lane_ms:.9f} ms); "
                f"scratch {scratch / 1e6:.3f} MB a call; library call: "
                "none, no single op computes a scan's gradient")
            out = (timed, bms, by, f"{what}, B={B}, T={T}, H={H}, dh={dh}, "
                   f"N={N}, bf16")
        elif timed_here:
            dev_ms, call_ms = time_calls(
                lambda *a: kssd.ssd_bwd(*a[:8], saved=a[8]), with_states, 64)
            reduced_ms = dev_ms
            say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms per "
                "launch (the hybrid's main-path launches are at this shape)")
        del draws
        if timed_here:
            del kept, with_states
    timed, bms, by, shape = out
    say(f"ssd_bwd: main-path launches {launches['ssd_bwd']}")
    return [dict(row("ssd_bwd", launches, err, timed, bms, by, None, shape),
                 recompute_ms=timed["recompute_ms"], reduced_ms=reduced_ms)]


def sdpa_bwd(batches, H: int, Hk: int, window, reps: int,
             causal: bool = True):
    """The library call's time: the backward kernels of autograd through
    ``scaled_dot_product_attention`` (kv heads repeated beforehand, the
    window as a boolean mask) on the same inputs (``time_calls``)."""
    lib = []
    for q, k, v, _, dout, _ in batches:
        T, S = q.shape[1], k.shape[1]
        qs = q.transpose(1, 2).contiguous().requires_grad_()
        ks, vs = (t.repeat_interleave(H // Hk, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_() for t in (k, v))
        mask = None
        if window is not None:
            qp = torch.arange(T, device=q.device)[:, None] + (S - T)
            kp = torch.arange(S, device=q.device)[None, :]
            mask = (kp <= qp) & (kp > qp - window)
        o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None)
        lib.append((o, qs, ks, vs, dout.transpose(1, 2).contiguous()))
    return time_calls(lambda o, a, b, c, d: torch.autograd.grad(
        o, (a, b, c), d, retain_graph=True), lib, reps)


# the backward kernel's shapes (tag, B, T, S, H, Hk, dh, window, causal):
# MiniCPM-2B's training shape (the main path's), Qwen2-0.5B's heads at
# T = 512, StarCoder2-15B's heads with a window of 512 over T = 1100 (not
# a multiple of 64), the hybrid's training shape at reduced() (dh = 32,
# one kv head), Whisper-tiny's training batch, not causal: its encoder
# over 1500 frames (23 key tiles of 64 and 28) and its cross attention,
# 64 queries against the 1500 encoder rows; and InternVL2-76B's training
# batch at full width, causal over 1025 patches and 64 text tokens (1089
# = 17 * 64 + 1), 64 query heads over 8 kv heads of 128
BWD_SHAPES = (("MiniCPM-2B training", 8, 64, 64, 36, 36, 64, None, True),
              ("Qwen2-0.5B T=512", 1, 512, 512, 14, 2, 64, None, True),
              ("StarCoder2-15B heads, window 512", 1, 1100, 1100, 48, 4,
               128, 512, True),
              ("Jamba-1.5-Large reduced() training", 8, 64, 64, 4, 1, 32,
               None, True),
              ("Whisper-tiny encoder training", 8, 1500, 1500, 6, 6, 64,
               None, False),
              ("Whisper-tiny cross training", 8, 64, 1500, 6, 6, 64, None,
               False),
              ("InternVL2-76B training", 4, 1089, 1089, 64, 8, 128, None,
               True))


# the forward's log-sum-exp against the plain version's: each live row
# within LSE_TOL of max(1, |plain|) (fp32 scores summed in another
# order; the bf16 kernel converts from log2 units), +inf on the same rows
LSE_TOL = 1e-5


def lse_close(name: str, lse, plain) -> float:
    live = torch.isfinite(plain)
    check(torch.equal(torch.isfinite(lse), live)
          and bool((lse[~live] > 0).all()), f"{name}: the log-sum-exp is "
          "not +inf on exactly the rows that see no key")
    gap = float(((lse - plain).abs() / plain.abs().clamp_min(1.0))[live]
                .max()) if bool(live.any()) else 0.0
    check(gap <= LSE_TOL, f"{name}: the forward's log-sum-exp differs from "
          f"the plain version's by {gap:.3e} of max(1, |plain|)")
    return gap


def bwd_vs_plain(seed: int, launches: dict) -> list:
    """flash_attention_bwd against ``attention_bwd_plain`` in fp32 and
    bf16 at ``BWD_SHAPES``: dq, dk, dv each within ``attn_limit`` of the
    plain version elementwise, a limit the plain version without the D
    term breaks; two calls bit-identical (no atomics); its input, the
    forward's log-sum-exp, within ``LSE_TOL`` of the plain version's;
    then, in bf16, the kernel's and the plain version's times, SDPA's
    backward as the library call, and the bound (bytes over HBM
    bandwidth against the five products' FLOPs over the seen pairs at
    the bf16 tensor-core rate)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 24)
    measured = []
    err = 0.0
    for tag, B, T, S, H, Hk, dh, W, causal in BWD_SHAPES:
        seq = f"T=S={T}" if T == S else f"T={T}, S={S}"
        name = f"flash_attention_bwd ({tag}, B={B}, {seq}, H={H}, " \
            f"Hk={Hk}, dh={dh}" + (f", W={W}" if W else "") \
            + ("" if causal else ", not causal") + ")"
        shares = []
        batches = {}
        for dtype in (torch.float32, torch.bfloat16):
            draws = []
            for _ in range(4):
                q = torch.randn(B, T, H, dh, generator=gen, device=dev)
                k, v = (torch.randn(B, S, Hk, dh, generator=gen, device=dev)
                        for _ in range(2))
                dout = torch.randn(B, T, H, dh, generator=gen, device=dev)
                q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
                out, lse = kflash.flash_attention(q, k, v, causal=causal,
                                                  window=W, return_lse=True)
                draws.append((q, k, v, out, dout, lse))
            batches[dtype] = draws
            q, k, v, out, dout, lse = draws[0]
            gap = lse_close(f"{name} {str(dtype)[6:]}", lse,
                            kflash.attention_plain(q, k, v, causal=causal,
                                                   window=W,
                                                   return_lse=True)[1])
            got = kflash.flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                             causal=causal, window=W)
            again = kflash.flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                               causal=causal, window=W)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {str(dtype)[6:]}: two calls on the same inputs "
                  "differ")
            say(f"{name} {str(dtype)[6:]}: two calls bit-identical; the "
                f"forward's log-sum-exp within {gap:.3e} of max(1, |plain|)")
            plain = kflash.attention_bwd_plain(q, k, v, out, dout,
                                               causal=causal, window=W)
            no_d = kflash.attention_bwd_plain(q, k, v, torch.zeros_like(out),
                                              dout, causal=causal, window=W)
            caught = 0
            for part, g, p, b in zip(("dq", "dk", "dv"), got, plain, no_d):
                limit = attn_limit(p)
                diff = (g.float() - p.float()).abs()
                check(bool(torch.isfinite(g.float()).all()),
                      f"{name} {part}: non-finite output")
                check(bool((diff <= limit).all()), f"{name} {part} "
                      f"({dtype}): kernel differs from its plain version by "
                      f"up to {float((diff / limit).max())} times the limit")
                caught += int(((b.float() - p.float()).abs() > limit).sum())
                err = max(err, float(diff.max()))
                if dtype == torch.bfloat16:
                    shares.append(float((diff / limit).max()))
                say(f"{name} {part} {str(dtype)[6:]}: max abs err "
                    f"{float(diff.max()):.6g}, largest |plain| "
                    f"{float(p.float().abs().max()):.6g}, "
                    f"{float((diff / limit).max()):.4f} of the limit")
            check(caught > 0, f"{name}: the limit does not see the plain "
                  "version without the D term")
            say(f"{name} {str(dtype)[6:]}: the plain version without the D "
                f"term breaks the limit at {caught} elements")
        bf = batches[torch.bfloat16]
        timed = time_kernel(
            name, lambda a, b, c, o, d, l: kflash.flash_attention_bwd(
                a, b, c, o, d, lse=l, causal=causal, window=W),
            lambda a, b, c, o, d, l: kflash.attention_bwd_plain(
                a, b, c, o, d, causal=causal, window=W), bf, reps=64)
        lib_dev, lib_call = sdpa_bwd(bf, H, Hk, W, 16, causal)
        library_ms = lib_dev
        pairs = seen_pairs(T, S, W) if causal else T * S
        bms, by = work_bound(flash_bwd_work(B, T, S, H, Hk, dh, pairs))
        say(f"{name}: bound {bms:.9f} ms ({by}); scaled_dot_product_"
            f"attention's backward: device {lib_dev} ms, call "
            f"{lib_call:.6f} ms; bf16 share of the limit {max(shares):.4f}")
        measured.append((timed, bms, by, library_ms,
                         f"{tag}, B={B}, {seq}, H={H}, Hk={Hk}, dh={dh}"
                         + (f", W={W}" if W else "")
                         + ("" if causal else ", not causal") + ", bf16",
                         max(shares)))
        del batches, bf
    say(f"flash_attention_bwd: main-path launches "
        f"{launches['flash_attention_bwd']}")
    (timed, bms, by, library_ms, shape, _), *others = measured
    out = row("flash_attention_bwd", launches, err, timed, bms, by,
              library_ms, shape)
    out["other_shapes"] = [
        {"ms": t["ms"], **plain_of(t), "bound_ms": b,
         "bound_by": y, "library_ms": lib, "shape": sh, "limit_share": sr}
        for t, b, y, lib, sh, sr in others]
    return [out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the index loads run on the host at 1.3-36 kops/s (BwTree slowest):
    # these depths keep the whole run, with the serving, training and
    # share paths, within its time limit on the slower machines (an
    # H100 machine with a slow host took 1013 s at twice the P-CLHT,
    # P-ART, P-Masstree, CCEH and FAST&FAIR depths)
    ap.add_argument("--n-clht", type=int, default=1 << 18)
    ap.add_argument("--n-art", type=int, default=1 << 17)
    ap.add_argument("--n-hot", type=int, default=1 << 17)
    ap.add_argument("--n-masstree", type=int, default=1 << 16)
    ap.add_argument("--n-bwtree", type=int, default=1 << 14)
    # one CCEH directory and one Level hashing level must each fit an
    # arena segment (65,528 words): a 2^16-key CCEH load and a
    # 20,480-key Level hashing load overflow it
    ap.add_argument("--n-cceh", type=int, default=1 << 14)
    ap.add_argument("--n-fastfair", type=int, default=1 << 15)
    ap.add_argument("--n-level", type=int, default=1 << 14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phases = {}  # seconds of each phase, printed before the kernels line

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
    phases["build"] = time.perf_counter() - t0
    say(f"build: {sorted(built)} in {phases['build']:.3f} s")
    check(set(built) >= {"probe", "art_descend", "scan_window",
                         "shard_route", "conflict_any", "flash_attention",
                         "flash_attention_bwd", "paged_attention",
                         "clht_probe", "wkv6", "wkv6_bwd", "ssd",
                         "ssd_bwd"},
          "a kernel source was not built")
    logs = "".join(b.log for b in built.values())
    for name in ("partition_cluster_kernel", "partition_count_kernel",
                 "partition_scan_kernel", "partition_scatter_kernel",
                 "tag_probe_kernel", "clht_probe_kernel", "dq_tc_kernel",
                 "dkv_tc_kernel", "dkv_group_sum_kernel", "dq_simt_kernel",
                 "dkv_simt_kernel", "wkv6_bwd_kernel", "reduce_rows_kernel",
                 "reduce_du_kernel", "ssd_bwd_kernel", "reduce_heads_kernel",
                 "reduce_da_kernel", "reduce_da_chunks_kernel"):
        check(name in logs, f"{name} is not in the build's kernels")
    for source in ("wkv6_bwd", "ssd_bwd"):
        check("grads_kernel" in built[source].log, f"grads_kernel is not in "
              f"{source}'s build")
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
        phases[f"{tag} path"] = time.perf_counter() - t0
        say(f"{tag} path: {phases[f'{tag} path']:.3f} s; kernel launches "
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
    phases["scale-out path"] = time.perf_counter() - t0
    say(f"scale-out path: {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    for name in ("shard_partition", "conflict_any", "scan_window_sharded",
                 "probe64_fp", "scan_window"):
        check(counts[name] > 0, f"{name} was not launched on the scale-out "
              "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done

    t0 = time.perf_counter()
    serve = serving_run(SERVE_ARCH, args.seed, launches, split,
                        bf16_check=True)
    phases[f"{SERVE_ARCH} serving and checks"] = time.perf_counter() - t0
    # a full-width CPU run of a 512-token prompt is slow: the check takes
    # the path's 32-token prompt (the width is not cut)
    t0 = time.perf_counter()
    rwkv = serving_run(RWKV_ARCH, args.seed, launches, split,
                       extra=RWKV_EXTRA_PROMPTS, **WIDE)
    phases[f"{RWKV_ARCH} serving and checks"] = time.perf_counter() - t0

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
    phases["Mamba path and check"] = time.perf_counter() - t0

    # the reduced model is small: the check takes the longest prompt
    t0 = time.perf_counter()
    hybrid = serving_run(HYBRID_ARCH, args.seed, launches, split,
                         extra=HYBRID_EXTRA_PROMPTS, reduced=True, pick=max)
    phases[f"{HYBRID_ARCH} serving and checks"] = time.perf_counter() - t0

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
    phases["tag path"] = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    matrix_path(args.seed, torch.device("cuda", 0))
    counts = read_counts()
    phases["matrix path"] = time.perf_counter() - t0
    say(f"matrix path: {time.perf_counter() - t0:.3f} s; kernel launches "
        f"{counts}")
    for name in ("probe64_fp", "art_descend", "art_pack_entries",
                 "scan_window", "shard_partition", "conflict_any"):
        check(counts[name] > 0, f"{name} was not launched on the matrix "
              "path")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done

    # the MoE family and sliding windows; each path frees its model before
    # the next one draws (DeepSeek-MoE and StarCoder2 hold 32.6 and 31.9
    # GB of bf16 weights, Mixtral's 4 layers 20.3 GB)
    wide = {}
    for arch, kw in WIDE_PATHS.items():
        t0 = time.perf_counter()
        wide[arch] = serving_run(arch, args.seed, launches, split, **kw)
        phases[f"{arch} serving and checks"] = time.perf_counter() - t0

    # the training path: (a) MiniCPM-2B at full width, counted; (b) its
    # fp32 check; (c) the crash and restart run, counted on its own
    n_attn = get_arch(TRAIN_ARCH).n_layers
    reset_counts()
    t0 = t_train = time.perf_counter()
    trained = train_full_width(args.seed)
    counts = read_counts()
    say(f"training path (a): {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    remat = trained["out"]["remat"]
    for name, per in (("flash_attention", forward_launches(remat)),
                      ("flash_attention_bwd", 1)):
        check(counts[name] == TRAIN_STEPS * n_attn * per, f"{name} was "
              f"launched {counts[name]} times in {TRAIN_STEPS} training "
              f"steps of {n_attn} attention layers under remat {remat}")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done
    train_report(trained)
    params = trained.pop("out")["params"]
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    train_cpu_check(params, args.seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    remat_memory(args.seed, launches)
    phases["remat memory"] = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    remat = crash_restart_path(args.seed)["remat"]
    counts = read_counts()
    say(f"training path (c): {time.perf_counter() - t0:.3f} s; kernel "
        f"launches {counts}")
    want = CRASH_RUN["steps"] * get_arch(TRAIN_ARCH).reduced().n_layers
    for name, per in (("flash_attention", forward_launches(remat)),
                      ("flash_attention_bwd", 1)):
        check(counts[name] == want * per, f"{name} was launched "
              f"{counts[name]} times in the crash and restart run, not "
              f"{want * per}")
    for name, done in counts.items():
        launches[name] = launches.get(name, 0) + done

    phases["training path"] = time.perf_counter() - t_train
    t0 = time.perf_counter()
    recurrent_path(args.seed, launches)
    phases["recurrent training path"] = time.perf_counter() - t0

    # the encoder-decoder and VLM paths at model level; each counts its
    # phases (prefills, encoder, decode, training) exactly and frees its
    # models before the next draws
    t0 = time.perf_counter()
    whisper = whisper_path(args.seed, launches)
    phases[f"{WHISPER_ARCH} path and checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vlm = vlm_path(args.seed, launches)
    phases[f"{VLM_ARCH} path and checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cell = decode_cell(args.seed, launches)
    phases[f"{CELL_ARCH} {CELL_SHAPE} cell and checks"] = \
        time.perf_counter() - t0
    share = share_path(args.seed, launches)
    for arch, got in share.items():
        phases[f"{arch} 32 x 8 share"] = got["seconds"]

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
            (paged_vs_plain, (serve, wide[CODER_ARCH], args.seed,
                              launches, (whisper, vlm))),
            (paged_int8_vs_plain, (cell, args.seed, launches)),
            (flash_vs_plain, (serve, wide[CODER_ARCH], args.seed,
                              launches)),
            (bwd_vs_plain, (args.seed, launches)),
            (clht_vs_plain, (tag, launches)),
            (wkv6_vs_plain, (rwkv, args.seed, launches, split["wkv6"])),
            (wkv6_bwd_vs_plain, (args.seed, launches)),
            (ssd_vs_plain, (mamba, hybrid, args.seed, launches,
                            split["ssd"])),
            (ssd_bwd_vs_plain, (args.seed, launches))):
        t0 = time.perf_counter()
        rows += check_rows(*fargs)
        phases[check_rows.__name__] = time.perf_counter() - t0
        say(f"{check_rows.__name__}: {phases[check_rows.__name__]:.3f} s")
    t0 = time.perf_counter()
    at_share = share_kernels(share, args.seed)
    for r in rows:
        if r["name"] in at_share:
            r.setdefault("other_shapes", []).extend(at_share[r["name"]])
    phases["share_kernels"] = time.perf_counter() - t0
    say(f"share_kernels: {phases['share_kernels']:.3f} s")
    check([r["name"] for r in rows] == list(SOURCES), "a kernel is missing "
          "from the kernels line")
    phases["whole run"] = time.perf_counter() - t_start
    say("phase seconds: " + json.dumps(
        {name: round(secs, 3) for name, secs in phases.items()}))
    say(f"whole run: {phases['whole run']:.3f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
