"""Guards of the port's boundary: repro_torch imports neither JAX nor
the JAX package (its scale-out layer, baselines, configs, models,
serving runtime, training slice, launch modules and the dry run with its
sharding rules, meshes and roofline included), and its
entry points run on the card unless the caller asks for the CPU, never
falling back on their own."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.api import open_index
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.train import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch.api, repro_torch.convert, "
            "repro_torch.build, repro_torch.core.baselines, "
            "repro_torch.distributed.sharded, "
            "repro_torch.distributed.streams, "
            "repro_torch.distributed.mesh, repro_torch.configs, "
            "repro_torch.models, repro_torch.models.model, "
            "repro_torch.serving, repro_torch.serving.engine, "
            "repro_torch.launch, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.kernels.rwkv6_scan, "
            "repro_torch.kernels.clht_probe, repro_torch.models.rwkv, "
            "repro_torch.kernels.mamba_scan, repro_torch.models.mamba, "
            "repro_torch.models.ffn, repro_torch.data.workloads, "
            "repro_torch.obs.trace, repro_torch.core.crash_testing, "
            "repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.optim.schedules, repro_torch.checkpoint, "
            "repro_torch.checkpoint.store, repro_torch.data.pipeline, "
            "repro_torch.launch.elastic, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.kernels.grad_guard, "
            "repro_torch.distributed.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.analysis, "
            "repro_torch.analysis.roofline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_of_the_port_imports_jax_or_repro():
    offenders = []
    sources = [p for p in sorted(PORT.rglob("*.py"))
               if "_build" not in p.relative_to(PORT).parts]  # build output
    for path in sources:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if FORBIDDEN.match(line):
                offenders.append(f"{path.relative_to(ROOT)}:{no}: {line}")
    assert not offenders, offenders
    assert len(sources) > 20  # the scan saw the package


@pytest.mark.parametrize("kind", ["clht", "P-ART", "hot", "masstree",
                                  "P-BwTree", "cceh", "fastfair", "level"])
def test_open_index_defaults_to_the_card_and_never_falls_back(monkeypatch,
                                                              kind):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_index(kind)
    with pytest.raises(RuntimeError):
        open_index(kind, device="cuda")
    s = open_index(kind, device="cpu")
    assert s.device == torch.device("cpu")
    assert s.index.device == torch.device("cpu")
    s.put(5, 6)
    assert s.get(5) == 6


@pytest.mark.parametrize("kind", ["cceh", "fastfair", "level"])
def test_unported_kinds_raise(kind, monkeypatch):
    """The kinds that were still to port (the three baselines) are
    ported: they open like the others, sharded too, and only a name
    that is no kind of the JAX package raises."""
    s = open_index(kind, device="cpu", shards=2)
    assert s.shards == 2 and s.index.device == torch.device("cpu")
    s.put(5, 6)
    assert s.get(5) == 6
    with pytest.raises(ValueError, match="unknown index kind"):
        open_index(kind + "x", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_index(kind, shards=2)


@pytest.mark.parametrize("entry", ["train", "store", "pipeline"])
def test_training_entry_points_default_to_the_card(monkeypatch, entry):
    """``train``, ``CheckpointStore`` and ``TokenPipeline`` (whose P-CLHT
    tables take a device) run on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"train": lambda **kw: train("qwen2-0.5b", steps=0,
                                        verbose=False, **kw),
            "store": lambda **kw: CheckpointStore(**kw),
            "pipeline": lambda **kw: TokenPipeline(
                DataConfig(vocab=100, seq_len=8, global_batch=2, n_docs=16,
                           mean_doc_len=16), **kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError):
        make(device="cuda")
    make(device="cpu")
