#!/usr/bin/env python3
"""Time the attention backward kernel (row 9b) and the forward that feeds
it (row 9) on one card, against the parent's.

    python3 tools/attention_bwd_variants.py [--parent DIR] [--seed S]
                                            [--reps N]

At ``chip_smoke.py``'s ``BWD_SHAPES`` (MiniCPM-2B's training shape,
Qwen2-0.5B's heads at T = 512, StarCoder2-15B's heads with a window of
512 over T = 1100, the hybrid's reduced() training shape, Whisper-tiny's
encoder and cross attention not causal), in bf16 on inputs drawn from
``--seed``:

* this tree's ``flash_attention_bwd`` (fed the forward's log-sum-exp),
  held to ``attention_bwd_plain`` within ``chip_smoke.attn_limit`` and
  timed with ``chip_smoke.time_calls`` (device time a call, CUDA
  events around calls queued behind a sleep kernel; the profiler line
  names the three kernels);
* with ``--parent DIR`` (a checkout of the commit before this design,
  e.g. ``git archive HEAD~1 src/repro_torch | tar -x -C DIR``), the
  parent's backward built from its ``csrc/flash_attention_bwd.cu`` and
  called through its own C interface on the same inputs, held to the
  same limit, and timed in turns with this tree's (parent, this tree,
  this tree, parent);
* the forward at Qwen2-0.5B's prefill shape (T = 512), without and with
  its log-sum-exp, in turns with the parent's forward where given
  (parent, without, with, with, without, parent).

Prints the card's name and power limit first.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
P, I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: Path, workdir: Path, say) -> dict:
    """The parent's forward and backward sources, built in parallel
    with this tree's flags and loaded with their own C interfaces."""
    from repro_torch import build
    import chip_smoke as cs
    procs = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        so = workdir / f"parent_{name}.so"
        src = parent / "src/repro_torch/csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed on the parent's "
                 f"{name}.cu:\n{log}")
        for line in cs.ptxas_lines(log):
            say(f"  parent {name}: {line}")
        libs[name] = ctypes.CDLL(str(so))
    libs["flash_attention"].flash_attention.argtypes = (
        [P] * 4 + [I] * 9 + [ctypes.c_float, P])
    libs["flash_attention_bwd"].flash_attention_bwd.argtypes = (
        [P] * 10 + [I] * 9 + [ctypes.c_float, P])
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=64)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import build
    from repro_torch.kernels import flash_attention as kflash

    say = cs.say
    cs.check(torch.cuda.is_available(), "no CUDA device")
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 25)
    for name, b in build.build(["flash_attention",
                                "flash_attention_bwd"]).items():
        for line in cs.ptxas_lines(b.log):
            say(f"  {name}: {line}")

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def dev_ms(fn, batches) -> float:
        ms, call_ms = cs.time_calls(fn, batches, args.reps)
        return ms if ms is not None else call_ms

    with tempfile.TemporaryDirectory() as tmp:
        parent = (build_parent(args.parent.resolve(), Path(tmp), say)
                  if args.parent is not None else None)

        def parent_bwd(q, k, v, out, dout, window, causal):
            B, T, H, dh = q.shape
            S, Hk = k.shape[1], k.shape[2]
            grads = (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v))
            scratch = torch.empty(2, B, H, T, dtype=torch.float32,
                                  device=dev)
            err = parent["flash_attention_bwd"].flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), *(g.data_ptr() for g in grads),
                scratch[0].data_ptr(), scratch[1].data_ptr(), B, T, S, H, Hk,
                dh, int(causal), int(window or 0), 1, 1.0 / math.sqrt(dh),
                stream())
            cs.check(err == 0, f"the parent's backward failed: {err}")
            return grads

        def parent_fwd(q, k, v):
            B, T, H, dh = q.shape
            out = torch.empty_like(q)
            err = parent["flash_attention"].flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, k.shape[1], H, k.shape[2], dh, 1, 0, 1,
                1.0 / math.sqrt(dh), stream())
            cs.check(err == 0, f"the parent's forward failed: {err}")
            return out

        def within(name, got, plain):
            worst = 0.0
            for part, g, p in zip(("dq", "dk", "dv"), got, plain):
                ratio = float(((g.float() - p.float()).abs()
                               / cs.attn_limit(p)).max())
                cs.check(ratio <= 1.0, f"{name} {part}: {ratio} times the "
                         "limit")
                worst = max(worst, ratio)
            return worst

        for tag, B, T, S, H, Hk, dh, W, causal in cs.BWD_SHAPES:
            name = f"{tag} (B={B}, T={T}, S={S}, H={H}, Hk={Hk}, dh={dh}" + (
                f", W={W}" if W else "") + ("" if causal else
                                            ", not causal") + ", bf16)"
            batches = []
            for _ in range(4):
                q = torch.randn(B, T, H, dh, generator=gen, device=dev)
                k, v = (torch.randn(B, S, Hk, dh, generator=gen, device=dev)
                        for _ in range(2))
                dout = torch.randn(B, T, H, dh, generator=gen, device=dev)
                q, k, v, dout = (t.bfloat16() for t in (q, k, v, dout))
                out, lse = kflash.flash_attention(q, k, v, causal=causal,
                                                  window=W, return_lse=True)
                batches.append((q, k, v, out, dout, lse))
            q, k, v, out, dout, lse = batches[0]
            plain = kflash.attention_bwd_plain(q, k, v, out, dout,
                                               causal=causal, window=W)

            def this(a, b, c, o, d, l, W=W, causal=causal):
                return kflash.flash_attention_bwd(a, b, c, o, d, lse=l,
                                                  causal=causal, window=W)

            worst = within(name, this(*batches[0]), plain)
            if parent is None:
                say(f"row 9b {name}: this tree {dev_ms(this, batches):.6f} "
                    f"ms ({worst:.3f} of the limit)")
                continue

            def old(a, b, c, o, d, l, W=W, causal=causal):
                return parent_bwd(a, b, c, o, d, W, causal)

            pworst = within(f"parent {name}", old(*batches[0]), plain)
            ms = [dev_ms(f, batches) for f in (old, this, this, old)]
            say(f"row 9b {name}: " + ", ".join(f"{m:.6f}" for m in ms)
                + f" ms (parent, this tree, this tree, parent); this tree "
                f"{worst:.3f} of the limit, the parent {pworst:.3f}; "
                f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x")

        # row 9: the forward at Qwen2-0.5B's prefill, T = 512
        batches = [tuple(torch.randn(shape, generator=gen, device=dev)
                         .bfloat16() for shape in ((1, 512, 14, 64),
                                                   (1, 512, 2, 64),
                                                   (1, 512, 2, 64)))
                   for _ in range(8)]

        def without(a, b, c):
            return kflash.flash_attention(a, b, c)

        def with_lse(a, b, c):
            return kflash.flash_attention(a, b, c, return_lse=True)

        order = ([parent_fwd] if parent else []) + [without, with_lse,
                                                    with_lse, without] + (
            [parent_fwd] if parent else [])
        if parent:
            cs.check(torch.equal(parent_fwd(*batches[0]),
                                 without(*batches[0])),
                     "the forward's output changed")
        ms = [dev_ms(f, batches) for f in order]
        labels = (["parent"] if parent else []) + [
            "without LSE", "with LSE", "with LSE", "without LSE"] + (
            ["parent"] if parent else [])
        say("row 9 forward, T = S = 512, H = 14, Hk = 2, dh = 64, bf16: "
            + ", ".join(f"{m:.6f}" for m in ms) + " ms ("
            + ", ".join(labels) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
