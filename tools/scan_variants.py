#!/usr/bin/env python3
"""Time variants of the two recurrent scans' CUDA sources on one card.

    python3 tools/scan_variants.py

Builds ``src/repro_torch/csrc/wkv6.cu`` and ``csrc/ssd.cu`` as they stand
and variants made from them by textual edits (an edit that no longer
applies fails the run), and times each bf16 prefill with
``chip_smoke.time_calls`` (device time a call, the call's kernels
timed by events around calls queued behind a sleep kernel) at RWKV6-7B's shape (B = 1, T = 512, H = 64, dh = 64) and
Jamba's (B = 1, T = 4096, H = 256, dh = 64, N = 16), on inputs drawn
from a seed as ``chip_smoke.py`` draws them:

* ``ssd``: a chunk of 128 steps instead of 64; 4 or 16 heads a block of
  the outputs kernel instead of 8; three head buffers instead of two;
* the outputs kernels' skeletons: their loads, prefix sums, block-wide
  factors and stores, with every product removed, which is what the
  kernels spend besides their arithmetic;

and ``wkv6`` as it stands at RWKV6-7B's prompts of 32 and 64 tokens (a
chunk of 64 half or wholly full), and counts the tensor-core (HMMA) and
asynchronous-copy (LDGSTS) instructions in the two sources' SASS with
the toolkit's ``cuobjdump``.

Variants that compute the same function are held to the source's
outputs within ``chip_smoke.ATTN_STEPS`` and its final state within
2e-5 of the largest magnitude; skeletons compute nothing and are only
timed.  Prints the card's name and power limit, then one line a build.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import build  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"scan_variants: an edit no longer applies: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def source(name: str) -> str:
    """csrc/<name>.cu with the header it shares with its backward
    (csrc/<name>_chunk.cuh) written in, so that an edit may reach either
    and a variant builds from one file."""
    csrc = ROOT / "src/repro_torch/csrc"
    include = f'#include "{name}_chunk.cuh"'
    header = (csrc / f"{name}_chunk.cuh").read_text()
    return (csrc / f"{name}.cu").read_text().replace(
        include, header.replace("#pragma once\n", ""))


WKV = source("wkv6")
SSD = source("ssd")
# (name, source, computes the same function)
VARIANTS = [
    ("wkv6", WKV, True),
    ("wkv6 outputs skeleton", edited(WKV, [
        ("    for (int d = 0; d < kDh; d += 2) {",
         "    for (int d = 0; d < 0; d += 2) {"),
        ("    if (inter) {\n      uint32_t ah[4], al[4];",
         "    if (inter && warp < 0) {\n      uint32_t ah[4], al[4];"),
        ("    if (warp > 0) {\n      uint32_t ah[4], al[4];",
         "    if (warp < 0) {\n      uint32_t ah[4], al[4];"),
        ("    if (i > warp) break;\n    float t0f[4], t1f[4];",
         "    if (i > warp || warp >= 0) break;\n    float t0f[4], t1f[4];"),
    ]), False),
    ("ssd", SSD, True),
    ("ssd kChunk 128", edited(SSD, [("constexpr int kChunk = 64;",
                                     "constexpr int kChunk = 128;")]), True),
    ("ssd 4 heads a block", edited(SSD, [("constexpr int kHeads = 8;",
                                          "constexpr int kHeads = 4;")]),
     True),
    ("ssd 16 heads a block", edited(SSD, [("constexpr int kHeads = 8;",
                                           "constexpr int kHeads = 16;")]),
     True),
    ("ssd 3 buffers", edited(SSD, [("constexpr int kBufs = 2;",
                                    "constexpr int kBufs = 3;")]), True),
    ("ssd outputs skeleton", edited(SSD, [
        ("      if (ks > warp) break;\n      float cb[2][4]",
         "      if (ks > warp || warp >= 0) break;\n      float cb[2][4]"),
        ("    if (inter) {\n      const float* S = sbuf(i);",
         "    if (inter && warp < 0) {\n      const float* S = sbuf(i);"),
    ]), False),
]


def compile_all(workdir: Path) -> dict:
    procs = {}
    for i, (name, src, _) in enumerate(VARIANTS):
        cu = workdir / f"v{i}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"scan_variants: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if name.startswith("wkv6"):
            lib.wkv6.argtypes = [P] * 9 + [I] * 5 + [P]
            lib.wkv6_scratch_floats.argtypes = [I] * 5
            lib.wkv6_scratch_floats.restype = ctypes.c_longlong
        else:
            lib.ssd.argtypes = [P] * 9 + [I] * 6 + [P]
            lib.ssd_scratch_floats.argtypes = [I] * 6
            lib.ssd_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def wkv6_call(lib):
    def call(r, k, v, logw, u, state=None):
        B, T, H, dh = r.shape
        out = torch.empty_like(r)
        final = torch.empty(B, H, dh, dh, device=r.device)
        scratch = torch.empty(lib.wkv6_scratch_floats(B, T, H, dh, 1),
                              device=r.device)
        err = lib.wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u.data_ptr(),
                       state.data_ptr() if state is not None else None,
                       out.data_ptr(), final.data_ptr(), scratch.data_ptr(),
                       B, T, H, dh, 1,
                       torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"wkv6 variant launch failed ({err})")
        return out, final
    return call


def ssd_call(lib):
    def call(x, dt, Bm, Cm, A, state=None):
        B, T, H, dh = x.shape
        N = Bm.shape[-1]
        y = torch.empty_like(x)
        final = torch.empty(B, H, dh, N, device=x.device)
        scratch = torch.empty(lib.ssd_scratch_floats(B, T, H, dh, N, 1),
                              device=x.device)
        err = lib.ssd(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                      Cm.data_ptr(), A.data_ptr(),
                      state.data_ptr() if state is not None else None,
                      y.data_ptr(), final.data_ptr(), scratch.data_ptr(),
                      B, T, H, dh, N, 1,
                      torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"ssd variant launch failed ({err})")
        return y, final
    return call


def main() -> int:
    cs.check(torch.cuda.is_available(), "no CUDA device")
    say = cs.say
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(Path(tmp))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(16)
        wkv = [cs.wkv_draw(gen, 512, 64, 64, False) for _ in range(8)]
        gen.manual_seed(18)
        ssd = [cs.ssd_draw(gen, 4096, 256, 64, 16, False) for _ in range(6)]
        refs = {}
        for name, _, same in VARIANTS:
            call = (wkv6_call if name.startswith("wkv6") else ssd_call)(
                libs[name])
            batches = wkv if name.startswith("wkv6") else ssd
            out, final = call(*batches[0])
            torch.cuda.synchronize()
            base = name.split()[0]
            note = ""
            if base == name:
                refs[base] = (out, final)
            elif same:
                ref, ref_final = refs[base]
                ok = bool(((out.float() - ref.float()).abs()
                           <= cs.attn_limit(ref)).all()) and float(
                    (final - ref_final).abs().max()) <= 2e-5 * float(
                    ref_final.abs().max())
                cs.check(ok, f"{name}: differs from {base}")
                note = f"; outputs and state within the limits of {base}'s"
            dev_ms, call_ms = cs.time_calls(call, batches,
                                            64 if base == "wkv6" else 32)
            say(f"{name}: device {dev_ms} ms, call {call_ms:.6f} ms a "
                f"call{note}")
        gen.manual_seed(16)
        for T in (32, 64):
            batches = [cs.wkv_draw(gen, T, 64, 64, False) for _ in range(8)]
            dev_ms, call_ms = cs.time_calls(wkv6_call(libs["wkv6"]), batches,
                                            64)
            say(f"wkv6 at T = {T}: device {dev_ms} ms, call {call_ms:.6f} ms "
                "a call")
        cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
        for i, (name, _, _) in enumerate(VARIANTS):
            if name in ("wkv6", "ssd"):
                sass = subprocess.run([str(cuobjdump), "-sass",
                                       str(Path(tmp) / f"v{i}.so")],
                                      capture_output=True, text=True,
                                      check=True).stdout
                say(f"{name} SASS: {sass.count('HMMA')} HMMA, "
                    f"{sass.count('LDGSTS')} LDGSTS instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
