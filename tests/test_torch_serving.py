"""The port's serving runtime (repro_torch, device="cpu") against the JAX
package: the engine, the ``serve`` driver, the pipeline layer and
pipelined streams.

Both packages' ``Server``s run the same model: the JAX package's
Qwen2-0.5B reduced configuration from ``PRNGKey(0)``, cast to fp32 and
carried into the port's ``LM`` by ``convert.lm_params_from_arrays``.
On ``tests/test_serving_batched.py``'s workloads (prompts drawn with
numpy from a seed) the served tokens must be equal, every serving stat
bit-equal (all but ``recovery_time_to_first_served_us``, a host-clock
time) and the PMem counters bit-equal: blocking, pipelined, through
``crash_and_recover``, with two sessions and with a page pool too small
for the queue.  The metadata plane is integer code, so these compare
with no tolerance; fp32 logits agree within 1e-4 (``test_torch_model``),
far from a tie in these runs.

Then ``tests/test_pipeline.py``'s ``AsyncExporter``, ``PlanPipeline``
and pipelined ``StreamDriver`` cases, on the port's classes.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import PMem as JPMem
from repro.launch.serve import serve as jax_serve
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import Server as JServer
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core import PCLHT, PMem, Plan
from repro_torch.distributed import StreamDriver
from repro_torch.launch.serve import serve
from repro_torch.models import LM
from repro_torch.serving import AsyncExporter, PlanPipeline, Server

CPU = torch.device("cpu")
TIMED = "recovery_time_to_first_served_us"


@pytest.fixture(scope="module")
def served():
    cfg = get_arch("qwen2-0.5b").reduced()
    jcfg = jax_get_arch("qwen2-0.5b").reduced()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(jax.tree.map(np.asarray, jp),
                                             cfg), assign=True)
    return cfg, jm, jp, lm


def servers(served, **kw):
    """(JAX server, port server) over the same weights and page pool."""
    cfg, jm, jp, lm = served
    kw = {"page_size": 8, "n_pages": 128, **kw}
    return (JServer(jm, jp, pmem=JPMem(), **kw),
            Server(lm, pmem=PMem(), **kw))


def prompts(cfg, seed, n, length, prefix=0):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, cfg.vocab, prefix)]
    return [shared + [int(t) for t in rng.integers(1, cfg.vocab,
                                                   length - prefix)]
            for _ in range(n)]


def assert_same(js, ts, jreqs, treqs):
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.done for r in treqs] == [r.done for r in jreqs]
    jstats = {k: v for k, v in dict(js.stats).items() if k != TIMED}
    tstats = {k: v for k, v in dict(ts.stats).items() if k != TIMED}
    assert tstats == jstats
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert ts.pmem.crashes == js.pmem.crashes


def drain_both(pair, batches, *, max_len=48, pipelined=False, crash=False):
    """Submit each batch of prompts and drain, on both servers; with
    ``crash`` a ``crash_and_recover`` follows every batch but the last.
    Returns the requests of every batch, per server."""
    out = []
    for server in pair:
        reqs = []
        for i, batch in enumerate(batches):
            for p in batch:
                server.submit(p, max_new=6)
            reqs += list(server.queue)
            server.run_until_drained(max_len=max_len, pipelined=pipelined)
            if crash and i < len(batches) - 1:
                server.crash_and_recover()
        out.append(reqs)
    return out


@pytest.fixture(scope="module")
def blocking_run(served):
    cfg = served[0]
    pair = servers(served)
    jreqs, treqs = drain_both(pair, [prompts(cfg, 4, 4, 16)])
    return pair, jreqs, treqs


def test_blocking_server_matches_jax(blocking_run):
    (js, ts), jreqs, treqs = blocking_run
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert_same(js, ts, jreqs, treqs)
    assert ts.stats["decode_steps"] == 20 and ts.stats["prefill_tokens"] == 64


def test_pipelined_server_matches_jax_and_blocking(served, blocking_run):
    cfg = served[0]
    _, _, blocking = blocking_run
    js, ts = servers(served)
    jreqs, treqs = drain_both((js, ts), [prompts(cfg, 4, 4, 16)],
                              pipelined=True)
    assert_same(js, ts, jreqs, treqs)
    assert [r.out for r in treqs] == [r.out for r in blocking]
    assert ts.stats["pipeline_prebuilt_plans"] > 0


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["blocking", "pipelined"])
def test_crash_and_recover_matches_jax(served, pipelined):
    """Prompts sharing a 16-token prefix; a powerfail after the first
    batch drains; the same prompts again on the recovered image: warm
    prefixes survive and are hit, in both packages alike."""
    cfg = served[0]
    batch = prompts(cfg, 6, 3, 24, prefix=16)
    js, ts = servers(served)
    jreqs, treqs = drain_both((js, ts), [batch, batch], pipelined=pipelined,
                              crash=True)
    assert_same(js, ts, jreqs, treqs)
    assert ts.stats["warm_prefixes_restored"] > 0
    assert ts.stats["prefix_hits"] > 0
    assert ts.stats[TIMED] >= 0
    assert ts.exporter.backlog == 0 and ts._prebuilt is None


def test_crash_mid_pipelined_tick_matches_jax(served):
    """test_serving_batched's powerfail between pipelined ticks: staged
    exports and the pre-built plan die with the power, and the resumed
    run drains like the JAX server's."""
    cfg = served[0]
    pair = servers(served)
    reqs = []
    for server in pair:
        for p in prompts(cfg, 6, 3, 16):
            server.submit(p, max_new=6)
        server.step(48, pipelined=True)
        assert server._prebuilt is not None and server.running
        server.crash_and_recover()
        assert server._prebuilt is None and server.exporter.backlog == 0
        assert server.running == [] and server.caches == {}
        for p in prompts(cfg, 6, 3, 16):
            server.submit(p, max_new=6)
        resumed = list(server.queue)
        server.run_until_drained(max_len=48, pipelined=True)
        assert all(r.done for r in resumed)
        reqs.append(resumed)
    assert_same(*pair, *reqs)


def test_multi_session_matches_jax(served):
    cfg = served[0]
    pair = servers(served)
    reqs = []
    for server in pair:
        a, b = server.connect(), server.connect()
        for pa, pb in zip(prompts(cfg, 1, 3, 12), prompts(cfg, 2, 3, 12)):
            a.submit(pa, max_new=8)
            b.submit(pb, max_new=8)
        assert a.queued == 3 and b.queued == 3
        queued = list(server.queue)
        server.step(48)
        assert {r.sid for r in server.running} == {a.sid, b.sid}
        assert len(a.running) == 3 and len(b.running) == 3
        server.run_until_drained(max_len=48)
        reqs.append(queued)
    assert_same(*pair, *reqs)
    assert pair[1].stats["multi_session_ticks"] >= 1


def test_capacity_aware_admission_matches_jax(served):
    """Three pages for two 2-page prompts: the second requeues with its
    partial grant freed, then admits when the first finishes."""
    cfg = served[0]
    pair = servers(served, n_pages=3)
    reqs = []
    for server in pair:
        for p in prompts(cfg, 9, 2, 16):
            server.submit(p, max_new=8)
        queued = list(server.queue)
        server.step(48)
        assert [r.rid for r in server.running] == [0]
        assert [r.rid for r in server.queue] == [1]
        assert 1 not in server.caches
        held = sum(server.pmem.load(server.kv.bitmap, p) for p in range(3))
        assert held == 2
        server.run_until_drained(max_len=48)
        reqs.append(queued)
    assert_same(*pair, *reqs)


def test_decode_ticks_issue_no_pm_loads(served):
    """After the admission tick, steady decode resolves every page
    translation through the batched path: PMem loads do not move."""
    cfg = served[0]
    server = Server(served[3], page_size=8, n_pages=128)
    for p in prompts(cfg, 0, 3, 24, prefix=16):
        server.submit(p, max_new=6)
    server.step(48)
    loads = server.pmem.counters.loads
    batches = server.stats["translation_batches"]
    server.step(48)
    server.step(48)
    assert server.pmem.counters.loads == loads
    assert server.stats["translation_batches"] == batches + 2
    for req in server.running:
        table = server.page_tables[req.rid]
        assert all(p is not None
                   for p in table[:len(req.prompt) // server.page_size])
    # the dense caches are whole pages: 48 slots for max_len 48
    assert all(c["blocks"]["l0"]["k"].shape[2] == 48
               for c in server.caches.values())


def test_restart_preserves_grants_and_warm_prefixes(served):
    """A new engine attached to the powerfailed PMem sees every
    acknowledged grant and warm prefix, with no repair pass."""
    cfg = served[0]
    pmem = PMem()
    server = Server(served[3], page_size=8, n_pages=128, pmem=pmem)
    prompt = prompts(cfg, 1, 1, 24)[0]
    rid = server.submit(prompt, max_new=4)
    server.run_until_drained(max_len=48)
    grants = [server.kv.lookup_page(rid, l) for l in range(3)]
    assert None not in grants
    covered, pages = server.kv.prefix_lookup(prompt)
    assert covered >= 16
    pmem.crash(mode="powerfail")
    again = Server(served[3], page_size=8, n_pages=128, pmem=pmem)
    assert again.kv.recover() > 0
    assert [again.kv.lookup_page(rid, l) for l in range(3)] == grants
    assert again.kv.prefix_lookup(prompt) == (covered, pages)
    assert all(pmem.load(again.kv.bitmap, p) == 1 for p in pages)


class _StubModel:
    cfg = None  # Server.__init__ reads only model.cfg


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(_StubModel(), page_size=8, n_pages=32)
    server = Server(_StubModel(), page_size=8, n_pages=32, device="cpu")
    assert server.kv.table.device == CPU == server.kv.prefix.device




def test_serve_reduced_matches_jax_serve():
    """``serve(reduced=True, device="cpu")`` is the JAX driver's run:
    other weights (a torch generator against PRNGKey), the same
    requests, so the same metadata plane: stats and PMem counters."""
    ts = serve("qwen2-0.5b", reduced=True, device="cpu", crash_midway=True,
               verbose=False)
    js = jax_serve("qwen2-0.5b", crash_midway=True, verbose=False)
    assert {k: v for k, v in dict(ts.stats).items() if k != TIMED} == \
        {k: v for k, v in dict(js.stats).items() if k != TIMED}
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert ts.stats["prefix_hits"] > 0 and ts.stats["warm_prefixes_restored"]
    assert ts.device == CPU


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's cases on the port
# ---------------------------------------------------------------------------
def _clht():
    return PCLHT(PMem(), n_buckets=16, device="cpu")


def _load(idx, keys):
    idx.execute(Plan.from_ops([("insert", k, k * 10 + 1) for k in keys]),
                collect_results=False)


def _stale_snapshot(idx):
    idx.snapshot()
    idx.execute(Plan.from_ops([("update", k, k + 500) for k in (1, 2, 3, 4)]),
                force_kernel=True, collect_results=False)
    assert idx._snapshot is not None
    assert idx._snapshot.epoch != idx._epoch_key()


class _SlowIndex:
    """Delegate that stretches ``execute`` so the pipeline queue builds
    up while every operation still runs on the real index."""

    def __init__(self, inner, delay=0.005):
        self._inner = inner
        self._delay = delay

    def execute(self, *args, **kwargs):
        time.sleep(self._delay)
        return self._inner.execute(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _mixed_plans(n_plans=12, n_ops=40, seed=3):
    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n_plans):
        ops = []
        for _ in range(n_ops):
            k = int(rng.integers(1, 30))
            r = rng.random()
            if r < 0.40:
                ops.append(("lookup", k, 0))
            elif r < 0.70:
                ops.append(("update", k, int(rng.integers(1, 1000))))
            elif r < 0.85:
                ops.append(("insert", k, int(rng.integers(1, 1000))))
            else:
                ops.append(("delete", k, 0))
        plans.append(Plan.from_ops(ops))
    return plans


def test_publish_export_rejects_outrun_build_whole():
    idx = _clht()
    _load(idx, range(1, 9))
    built = idx.build_export()
    idx.insert(99, 990)
    assert not idx.publish_export(built)
    assert idx._snapshot is None
    fresh = idx.build_export()
    assert idx.publish_export(fresh)
    assert idx._snapshot is fresh


def test_exporter_dedup_and_noop_accounting():
    ex = AsyncExporter()
    idx = _clht()
    _load(idx, range(1, 9))
    _stale_snapshot(idx)
    assert ex.submit(idx)
    assert not ex.submit(idx)
    assert ex.backlog == 1
    assert ex.run_pending() == 1
    assert ex.backlog == 0
    assert idx._snapshot.epoch == idx._epoch_key()
    assert ex.submit(idx)
    assert ex.run_pending() == 0
    assert ex.stats["published"] == 1
    assert ex.stats["noop"] == 1


def test_submit_if_stale_policy():
    ex = AsyncExporter()
    idx = _clht()
    _load(idx, range(1, 9))
    assert not ex.submit_if_stale(idx)
    idx.snapshot()
    assert not ex.submit_if_stale(idx)
    _stale_snapshot(idx)
    assert ex.submit_if_stale(idx)
    ex.run_pending()
    assert not ex.submit_if_stale(idx)


def test_discard_pending_is_the_crash_path():
    ex = AsyncExporter()
    idxs = []
    for _ in range(2):
        idx = _clht()
        _load(idx, range(1, 9))
        _stale_snapshot(idx)
        assert ex.submit_if_stale(idx)
        idxs.append(idx)
    assert ex.discard_pending() == 2
    assert ex.backlog == 0 and ex.stats["discarded"] == 2
    assert ex.run_pending() == 0
    for idx in idxs:
        assert idx._snapshot.epoch != idx._epoch_key()


def test_pipeline_bit_identical_to_blocking_while_coalescing():
    plans = _mixed_plans()
    idx_b = _clht()
    _load(idx_b, range(1, 30))
    base = [idx_b.execute(p) for p in plans]
    idx_p = _clht()
    _load(idx_p, range(1, 30))
    with PlanPipeline(_SlowIndex(idx_p), depth=8,
                      exporter=AsyncExporter()) as pipe:
        assert pipe._device is None  # a CPU index: no card to wait for
        got = [t.wait() for t in [pipe.submit(p) for p in plans]]
        stats = dict(pipe.stats)
    assert stats["coalesced_plans"] > 0 and stats["groups"] > 0
    assert [g.results for g in got] == [b.results for b in base]
    assert [(g.found, g.acked, g.scanned) for g in got] == \
        [(b.found, b.acked, b.scanned) for b in base]
    assert dict(idx_p.items()) == dict(idx_b.items())
    assert sum(g.probe.get("pm_gather_words", 0) for g in got) == \
        sum(b.probe.get("pm_gather_words", 0) for b in base)


def test_collect_results_false_never_coalesces():
    idx, oracle = _clht(), _clht()
    _load(idx, range(1, 9))
    _load(oracle, range(1, 9))
    plans = [Plan.from_ops([("update", k, 100 + i) for k in (1, 2, 3)])
             for i in range(6)]
    with PlanPipeline(_SlowIndex(idx), depth=8,
                      collect_results=False) as pipe:
        for p in plans:
            pipe.submit(p)
        pipe.drain()
        stats = dict(pipe.stats)
    assert stats["coalesced_plans"] == 0 and stats["groups"] == 0
    assert stats["plans"] == len(plans)
    for p in plans:
        oracle.execute(p, collect_results=False)
    assert dict(idx.items()) == dict(oracle.items())


def test_error_propagates_and_pipeline_survives():
    idx = _clht()
    _load(idx, range(1, 9))
    with PlanPipeline(idx) as pipe:
        bad = pipe.submit(Plan.from_ops([("lookup", 0, 0)]))  # 0 is NULL
        with pytest.raises(AssertionError):
            bad.wait()
        with pytest.raises(AssertionError):
            pipe.drain()
        ok = pipe.submit(Plan.from_ops([("lookup", 1, 0)]))
        assert ok.wait().results == [11]


def test_backpressure_stalls_are_counted():
    idx = _clht()
    _load(idx, range(1, 9))
    with PlanPipeline(_SlowIndex(idx, delay=0.01), depth=1) as pipe:
        for i in range(3):
            pipe.submit(Plan.from_ops([("lookup", 1 + i % 8, 0)]))
        pipe.drain()
        stats = dict(pipe.stats)
    assert stats["stalls"] > 0 and stats["max_depth"] >= 1


def _stream_workload(drv, plans_per_stream=4, seed=5):
    rng = np.random.default_rng(seed)
    for s, stream in enumerate(drv.streams):
        for j in range(plans_per_stream):
            ops = []
            for _ in range(10):
                k = int(rng.integers(1, 20))
                if rng.random() < 0.5:
                    ops.append(("lookup", k, 0))
                else:
                    ops.append(("update", k, 1 + s * 100 + j))
            stream.submit(Plan.from_ops(ops))


def test_stream_driver_pipelined_identity():
    idx_b = _clht()
    _load(idx_b, range(1, 20))
    drv_b = StreamDriver(idx_b, 3)
    _stream_workload(drv_b)
    tickets_b = [t for s in drv_b.streams for t in s.queue]
    drv_b.run()
    idx_p = _clht()
    _load(idx_p, range(1, 20))
    drv_p = StreamDriver(idx_p, 3)
    _stream_workload(drv_p)
    tickets_p = [t for s in drv_p.streams for t in s.queue]
    with PlanPipeline(idx_p, depth=4) as pipe:
        drv_p.run_pipelined(pipe)
    assert [t.result for t in tickets_p] == [t.result for t in tickets_b]
    assert [t.tick for t in tickets_p] == [t.tick for t in tickets_b]
    for name in ("ticks", "admitted_plans", "deferred_plans", "merged_ops",
                 "multi_stream_ticks", "found", "acked", "scanned"):
        assert drv_p.stats[name] == drv_b.stats[name], name
    assert dict(idx_p.items()) == dict(idx_b.items())


def test_stream_driver_pipelined_defers_conflicts_identically():
    def conflicting(drv):
        for i in range(6):
            drv.streams[i % 2].submit(Plan.from_ops(
                [("update", k, 100 + i) for k in (5, 6, 7)]))

    idx_b = _clht()
    _load(idx_b, (5, 6, 7))
    drv_b = StreamDriver(idx_b, 2, collect_results=False)
    conflicting(drv_b)
    drv_b.run()
    idx_p = _clht()
    _load(idx_p, (5, 6, 7))
    drv_p = StreamDriver(idx_p, 2, collect_results=False)
    conflicting(drv_p)
    with PlanPipeline(idx_p, depth=4, collect_results=False) as pipe:
        drv_p.run_pipelined(pipe)
    assert drv_b.stats["deferred_plans"] > 0
    assert drv_p.stats["deferred_plans"] == drv_b.stats["deferred_plans"]
    assert drv_p.stats["ticks"] == drv_b.stats["ticks"]
    assert dict(idx_p.items()) == dict(idx_b.items())


def test_server_streams_survive_crash_and_recover():
    """Streams write through the server's PM prefix index; a powerfail
    lands mid-traffic; every acked write reads back and the resumed
    streams end on their program-order values."""
    server = Server(_StubModel(), page_size=8, n_pages=32, device="cpu")
    drv = server.streams(3)
    n_plans = 5
    val = lambda s, j: 1 + s * 1000 + j  # noqa: E731 — nonzero (P-ART)
    for s, stream in enumerate(drv.streams):
        for j in range(n_plans):
            stream.submit(Plan.from_ops([("update", 100 + s, val(s, j))]))
    for _ in range(2):
        drv.tick()
    acked = {}
    for s, stream in enumerate(drv.streams):
        done = n_plans - len(stream.queue)
        assert done >= 1
        acked[s] = val(s, done - 1)
    server.kv.prefix.snapshot()
    server.exporter.submit(server.kv.prefix)
    server.crash_and_recover()
    assert server.exporter.backlog == 0
    assert server.stats["async_exports_discarded"] >= 1
    assert server._prebuilt is None
    for s in range(3):
        assert server.kv.prefix.lookup(100 + s) == acked[s]
    drv.run()
    for s in range(3):
        assert server.kv.prefix.lookup(100 + s) == val(s, n_plans - 1)
    assert drv.pending() == 0
    assert server.stats["stream_ticks"] == drv.stats["ticks"]
