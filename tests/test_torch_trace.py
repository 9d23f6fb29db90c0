"""The port's Chrome-trace export (``repro_torch.obs.trace``) against the
JAX package's (``repro.obs.trace``), on the CPU:

* one plan's trace on P-CLHT, and a tick of two client streams over a
  4-shard P-CLHT: the same event names, ``cat``, ``ph``, ``pid``,
  ``tid`` and parent structure, and ``args`` equal apart from the times.
  The one attribute that differs is the kernel span's ``padded`` (and
  its ``pad_ratio``): the TPU kernel pads a batch to its query block,
  the port's takes the batch as it is;
* every span the port records on every layer (``plan.*``,
  ``pmem.group_commit``, ``kernel.*``, ``streams.tick``, ``shard.*``,
  ``serve.*``) holds plain Python values, so ``json.dump`` takes the
  trace as it stands and the validator passes it;
* the validator's verdicts on the JAX tests' bad events;
* ``python -m repro_torch.obs.trace`` exits 0 on a valid trace, 1 on an
  invalid one and 2 on a wrong command line.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.api import open_index as jax_open_index
from repro.core.plan import Plan as JPlan
from repro.core.ycsb import generate as jax_generate
from repro.obs.trace import validate_chrome_trace as jax_validate
from repro_torch import obs
from repro_torch.api import Plan, open_index
from repro_torch.configs import get_arch
from repro_torch.core import PMem
from repro_torch.core.ycsb import generate, run_workload
from repro_torch.data.workloads import matrix_workload
from repro_torch.models import LM
from repro_torch.obs.trace import main, validate_chrome_trace
from repro_torch.serving import Server

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLAIN = (int, float, bool, str, type(None))
PADDING = ("padded", "pad_ratio")  # the TPU kernel's query-block padding


@pytest.fixture(autouse=True)
def quiet_recorders():
    for rec in (obs, jobs):
        rec.disable()
        rec.reset()
    yield
    for rec in (obs, jobs):
        rec.disable()
        rec.reset()


def traced(rec, fn):
    rec.reset()
    rec.enable()
    try:
        fn()
    finally:
        rec.disable()
    return rec.chrome_trace(rec.RECORDER)


def tree(events):
    """Each event's parent as an index into the event list."""
    at = {ev["args"]["span_id"]: i for i, ev in enumerate(events)}
    return [at.get(ev["args"].get("parent_id")) for ev in events]


def same_trace(jt, tt):
    assert validate_chrome_trace(tt) == [] and jax_validate(jt) == []
    je, te = jt["traceEvents"], tt["traceEvents"]
    assert [e["name"] for e in te] == [e["name"] for e in je]
    for key in ("cat", "ph", "pid", "tid"):
        assert [e[key] for e in te] == [e[key] for e in je], key
    assert tree(te) == tree(je)
    for j, t in zip(je, te):
        skip = PADDING if t["cat"] == "kernel" else ()
        assert {k: v for k, v in t["args"].items() if k not in skip} == \
            {k: v for k, v in j["args"].items() if k not in skip}, t["name"]
    assert json.loads(json.dumps(tt)) == tt
    return te


@pytest.mark.parametrize("reads_only", [False, True],
                         ids=["ycsb-a", "all-get"])
def test_plan_trace_matches_jax(reads_only):
    w = generate("A", 600, 600, seed=11)
    assert jax_generate("A", 600, 600, seed=11).run_ops == w.run_ops
    js, ts = jax_open_index("clht"), open_index("clht", device="cpu")
    warm = [("lookup", k, 0) for _, k, _ in w.load_ops]
    ops = warm[:512] if reads_only else w.run_ops[:512]
    for s, P in ((js, JPlan), (ts, Plan)):
        s.execute(P.from_ops(w.load_ops))
        s.execute(P.from_ops(warm))  # exports the snapshot
    jt = traced(jobs, lambda: js.execute(JPlan.from_ops(ops)))
    tt = traced(obs, lambda: ts.execute(Plan.from_ops(ops)))
    te = same_trace(jt, tt)
    cats = {e["cat"] for e in te}
    assert {"plan", "kernel"} <= cats
    assert ("pmem" in cats) != reads_only
    kernels = {e["name"] for e in te if e["cat"] == "kernel"}
    assert "kernel.clht_probe" in kernels
    assert kernels <= {"kernel.clht_probe", "kernel.partition"}
    if reads_only:  # a full query block: no padding on either side
        for j, t in zip(jt["traceEvents"], te):
            assert t["args"] == j["args"]


def test_stream_tick_trace_matches_jax():
    w = generate("A", 600, 600, seed=11)
    js = jax_open_index("clht", shards=4)
    ts = open_index("clht", device="cpu", shards=4)

    def streams(s, P):
        d = s.streams(2)
        for i in range(4):
            d.streams[i % 2].submit(P.from_ops(
                w.run_ops[i * 100:i * 100 + 150]))
        d.run()

    for s, P in ((js, JPlan), (ts, Plan)):
        s.execute(P.from_ops(w.load_ops))
    te = same_trace(traced(jobs, lambda: streams(js, JPlan)),
                    traced(obs, lambda: streams(ts, Plan)))
    names = {e["name"] for e in te}
    assert {"streams.tick", "shard.plan", "kernel.conflict",
            "kernel.partition", "pmem.group_commit"} <= names


def layers():
    """Plans on all eight kinds (reads, writes, scans), a 4-shard index
    on its mesh and per-shard read paths, a stream tick, and a server's
    admits, ticks and recovery at Qwen2-0.5B reduced."""
    for kind in ("clht", "art", "hot", "masstree", "bwtree", "cceh",
                 "fastfair", "level"):
        s = open_index(kind, device="cpu")
        ordered = kind not in ("clht", "cceh", "level")
        wl = matrix_workload("E" if ordered else "A", 300, 300,
                             dist="zipfian", seed=1)
        run_workload(s.index, wl, phase="load", batch_lookups=True)
        s.execute(Plan.from_ops([("lookup", k, 0)
                                 for _, k, _ in wl.load_ops]),
                  force_kernel=True)
        run_workload(s.index, wl, phase="run", batch_lookups=True,
                     max_batch=128)
    s = open_index("clht", device="cpu", shards=4, mesh_reads=True)
    wl = matrix_workload("A", 300, 300, dist="hotset", seed=1)
    run_workload(s.index, wl, phase="load", batch_lookups=True)
    reads = [("lookup", k, 0) for _, k, _ in wl.load_ops]
    s.execute(Plan.from_ops(reads))
    s.index.execute(Plan.from_ops(reads), mesh=False)
    drv = s.streams(2)
    for i in range(0, 300, 64):
        drv.streams[(i // 64) % 2].submit(
            Plan.from_ops(wl.run_ops[i:i + 64]))
    drv.run()
    cfg = get_arch("qwen2-0.5b").reduced()
    server = Server(LM(cfg, device="cpu"), pmem=PMem(), page_size=8,
                    n_pages=64)
    rng = np.random.default_rng(0)
    for pipelined in (False, True):
        for _ in range(2):
            server.submit([int(t) for t in rng.integers(1, cfg.vocab, 12)],
                          max_new=3)
        server.run_until_drained(max_len=24, pipelined=pipelined)
        server.crash_and_recover()


def test_every_layer_records_plain_attributes(tmp_path):
    t = traced(obs, layers)
    names = {e["name"] for e in t["traceEvents"]}
    cats = {e["cat"] for e in t["traceEvents"]}
    assert {"plan", "pmem", "kernel", "streams", "shard", "serve"} <= cats
    assert {"kernel.clht_probe", "kernel.art_probe", "kernel.scan",
            "kernel.conflict", "kernel.partition", "shard.mesh_lookup",
            "shard.plan", "serve.tick", "serve.recover"} <= names
    for sp in obs.spans():
        for key, value in sp.attrs.items():
            assert type(value) in PLAIN, (sp.name, key, type(value))
    path = tmp_path / "trace.json"
    obj = obs.write_trace(str(path))
    assert obj == t
    assert json.loads(path.read_text()) == obj
    assert obs.validate_trace_file(str(path)) == []


def bad_traces():
    """tests/test_obs.py's bad events, and a few more of each kind."""
    ok = {"name": "a", "cat": "a", "ph": "X", "ts": 0, "dur": 1,
          "pid": 1, "tid": 1, "args": {"span_id": 1}}
    return [
        {}, [], {"traceEvents": {}}, {"traceEvents": [{}]},
        {"traceEvents": [{**ok, "args": {"span_id": 1, "parent_id": 99}}]},
        {"traceEvents": [3, ok]},
        {"traceEvents": [{**ok, "ph": "B"}]},
        {"traceEvents": [{**ok, "name": ""}]},
        {"traceEvents": [{**ok, "ts": -1.0, "dur": "1"}]},
        {"traceEvents": [{**ok, "args": []}]},
        {"traceEvents": [{**ok, "args": {}}]},
        {"traceEvents": [ok]},
        {"traceEvents": []},
    ]


@pytest.mark.parametrize("i", range(len(bad_traces())))
def test_validator_verdicts_match_jax(i):
    obj = bad_traces()[i]
    got = validate_chrome_trace(obj)
    assert got == jax_validate(obj)
    assert (got == []) == (i >= len(bad_traces()) - 2)
    if i == 4:
        assert any("parent_id" in e for e in got)


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.trace", *args],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_trace_cli_exit_codes(tmp_path):
    good = tmp_path / "good.json"
    t = traced(obs, lambda: open_index("clht", device="cpu").execute(
        Plan.from_ops([("insert", k, k) for k in range(1, 40)])))
    good.write_text(json.dumps(t))
    out = run_cli(str(good))
    assert out.returncode == 0 and out.stdout.startswith("OK "), out
    assert main([str(good)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(bad_traces()[4]))
    out = run_cli(str(bad))
    assert out.returncode == 1 and "FAIL" in out.stdout, out
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert run_cli(str(broken)).returncode == 1
    assert run_cli(str(tmp_path / "missing.json")).returncode == 1
    for argv in ((), (str(good), str(bad))):
        out = run_cli(*argv)
        assert out.returncode == 2 and "usage" in out.stdout, out
    assert main([]) == 2
