"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface.  ``build``
compiles sources with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into shared libraries under ``_build/`` beside this file, one ``nvcc``
process per source, all started together.  A library's file name
carries a hash of its source, the headers beside it (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt
and a finished build is reused; each is written under a temporary name
and renamed into place, so processes that build at once never load a
half-written file; the compiler's output is kept beside it, so a reused
build still reports its registers and spills.  ``load`` builds one
source if needed and returns its ``ctypes.CDLL``.

Nothing here runs at import: the modules that launch kernels call
``load`` from inside their wrappers, so a machine without ``nvcc`` or a
card can import the package and run the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    """One source's build: the library, the seconds ``nvcc`` took (0.0
    when an earlier build was reused) and the compiler's output (the
    ``-Xptxas -v`` register and spill report, kept from the build that
    made the library)."""

    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: repro_torch builds its CUDA kernels "
                       "at first use with the CUDA toolkit's nvcc")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    """The library's path: the source's stem and a hash of the source,
    of every header beside it (``csrc/*.cuh``, which a source may
    include) and of the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named sources (every ``csrc/*.cu`` by default) that
    have no current build, in parallel; raise with the compiler's
    output if any fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(exist_ok=True)
    done: Dict[str, Built] = {}
    running = {}
    for name in names:
        src = CSRC / f"{name}.cu"
        out = _target(src)
        if out.exists():
            log = out.with_suffix(".log")
            done[name] = Built(out, 0.0,
                               log.read_text() if log.exists() else "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[name] = Built(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name].path))
    return lib


__all__ = ["BUILD_DIR", "Built", "build", "load", "sources"]
