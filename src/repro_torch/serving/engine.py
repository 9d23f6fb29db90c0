"""Serving engine: continuous batching over a paged KV cache whose
metadata plane is built from RECIPE-converted indexes.

* **Block table** — P-CLHT mapping (seq_id, logical_page) → physical
  page.  Every page grant is a Condition-#1 commit (value-then-key,
  flush+fence), so a crashed server restarts with a consistent page
  map: decoding sequences lose nothing that was acknowledged.
* **Prefix cache** — P-ART keyed by a rolling hash of token blocks
  (ordered index: longest-prefix matching walks the radix structure),
  mapping prefix-hash → page id, enabling cross-request KV reuse that
  SURVIVES RESTART — the RECIPE selling point applied to inference
  economics: a rebooted node skips re-prefilling warm prefixes.
* **Allocator** — free list persisted as a bitmap region; allocation
  commit = single atomic word store (bit set), GC reconciles leaks.

All index I/O goes through the operation-plan API: the engine builds
``Plan``s and calls ``RecipeIndex.execute`` — ONE plan per request
batch per index.  Every decode tick resolves all running sequences'
page translations with one read plan against the block table's
epoch-cached snapshot (kernels/clht_probe); admission gathers every
queued request for the tick and issues one read plan for all their
prefix probes (kernels/art_probe), one write plan for all their page
grants, and one write plan for all their prefix ingests.  The decode
hot path issues zero scalar ``lookup`` calls — writes (grants,
admissions) bump the index epoch and the next tick re-exports.
Restart recovery ends with a prefix-range warmup: batched scan plans
(kernels/scan) enumerate the surviving prefix cache and leave its
snapshot warm for the first admissions.

Write plans land on the sharded group-commit path (kernels/partition
shard routing + one ``PMem.group_commit`` persist epoch per shard
run), so an admission's flush/fence traffic amortizes across its
grants and — because a write wave invalidates only the shards it
wrote — prefix ingest no longer invalidates the whole prefix-cache
snapshot: the next admission's prefix probe serves warm shards from
the existing export (``RecipeIndex._shard_refine``) and walks only
the dirty ones.

The port of ``repro.serving.engine``.  The compute plane is the port's
``models.LM``: prefill attention on the flash-attention kernel and
decode attention on the paged-attention kernel, on the card unless the
caller asks for the CPU.  As in the JAX package, each running request
keeps a dense KV cache padded to the tick's ``max_len`` (here rounded
up to whole pages, ``ceil(max_len / page_size) * page_size`` slots),
and decode reads it through an identity block table: the pages the
block table grants (prompt pages only) carry the metadata plane's
crash consistency, not the tensors.  An RWKV6 model's requests carry
its recurrent state (``wkv``, ``shift_tm``, ``shift_cm``) instead, which
is not padded.  The index kernels run on the same
device: the block-table translations on the probe kernel, prefix probes
on the radix-descent kernel and the post-crash warmup on the sorted-run
search kernel.  Stats, spans and PMem traffic are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import PART, PCLHT, PMem, Plan
from ..device import resolve_device
from ..models.model import takes_front_inputs
from ..obs import RECORDER as _OBS
from ..obs import MetricsRegistry, MetricsView
from .pipeline import AsyncExporter

_M64 = (1 << 64) - 1


def _roll_hash(prev: int, block_tokens) -> int:
    h = prev or 1469598103934665603
    for t in block_tokens:
        h = ((h ^ int(t)) * 1099511628211) & _M64
    return (h & ((1 << 62) - 1)) | 1  # PM words are signed 64-bit


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0
    done: bool = False
    sid: int = 0  # submitting session (0 = the server's default)


class PagedKVManager:
    """Crash-consistent page metadata over a fixed page pool."""

    def __init__(self, pmem: PMem, n_pages: int, page_size: int, *,
                 device=None):
        self.pmem = pmem
        self.n_pages = n_pages
        self.page_size = page_size
        self.table = PCLHT(pmem, n_buckets=max(64, n_pages // 2),
                           name="kv.table", device=device)
        self.prefix = PART(pmem, name="kv.prefix", device=device)
        existing = pmem.find("kv.bitmap")
        self.bitmap = existing or pmem.alloc("kv.bitmap", n_pages)
        if existing is None:
            pmem.persist_region(self.bitmap)

    # -- allocator ------------------------------------------------------
    def alloc_page(self) -> Optional[int]:
        for p in range(self.n_pages):
            if self.pmem.load(self.bitmap, p) == 0:
                self.pmem.store(self.bitmap, p, 1)  # atomic commit
                self.pmem.persist(self.bitmap, p)
                return p
        return None

    def free_page(self, p: int) -> None:
        self.pmem.store(self.bitmap, p, 0)
        self.pmem.persist(self.bitmap, p)

    # -- block table ------------------------------------------------------
    @staticmethod
    def _bt_key(seq_id: int, logical: int) -> int:
        return ((seq_id << 20) | logical) + (1 << 60)

    def map_page(self, seq_id: int, logical: int, physical: int) -> None:
        self.table.insert(self._bt_key(seq_id, logical), physical + 1)

    def map_pages(self, seq_id: int, grants: List[Tuple[int, int]]) -> None:
        """Commit many ``(logical, physical)`` grants in one write plan
        — one group-commit persist epoch per touched shard instead of
        a flush+fence pair per grant."""
        self.map_pages_many([(seq_id, grants)])

    def map_pages_many(self, by_seq: List[Tuple[int, List[Tuple[int, int]]]]
                       ) -> None:
        """One write plan for a whole admission batch's grants: every
        ``(seq_id, [(logical, physical), ...])`` commits together —
        block-table keys are unique per (seq, logical), so the plan is
        a single conflict-free write wave."""
        plan = Plan()
        for seq_id, grants in by_seq:
            for l, p in grants:
                plan.put(self._bt_key(seq_id, l), p + 1)
        if len(plan):
            self.table.execute(plan, collect_results=False)

    def lookup_page(self, seq_id: int, logical: int) -> Optional[int]:
        v = self.table.lookup(self._bt_key(seq_id, logical))
        return None if v is None else v - 1

    def lookup_pages_batch(self, pairs: List[Tuple[int, int]], *,
                           force_kernel: bool = True
                           ) -> List[Optional[int]]:
        """Resolve many (seq_id, logical) translations in one batched
        probe over the block table's snapshot.  The decode hot path
        forces the kernel (default); the admission path passes
        ``force_kernel=False`` — it immediately follows its own grants,
        so adaptive dispatch may serve warm shards via ``_shard_refine``
        or go scalar instead of re-exporting per admission."""
        if not pairs:
            return []
        res = self.table.execute(self.translation_plan(pairs),
                                 force_kernel=force_kernel).results
        return [None if v is None else v - 1 for v in res]

    def translation_plan(self, pairs: List[Tuple[int, int]]) -> Plan:
        """The read plan resolving ``(seq_id, logical)`` translations —
        split out so the pipelined tick can pre-build (and pre-schedule)
        next tick's plan at the tail of the current one."""
        plan = Plan()
        for s, l in pairs:
            plan.get(self._bt_key(s, l))
        return plan

    def release_seq(self, seq_id: int, n_logical: int) -> None:
        """Tear down a sequence's translations with one batched probe
        and one sharded delete batch (deletes of never-mapped logicals
        are elided, so untouched shards keep their snapshot epochs)."""
        pairs = [(seq_id, l) for l in range(n_logical)]
        phys = self.lookup_pages_batch(pairs, force_kernel=False)
        plan = Plan()
        for (_, l), p in zip(pairs, phys):
            if p is not None:
                plan.delete(self._bt_key(seq_id, l))
        if len(plan):
            self.table.execute(plan, collect_results=False)
        for p in phys:
            if p is not None:
                self.free_page(p)

    # -- prefix cache -----------------------------------------------------
    def _block_hashes(self, tokens: List[int]) -> List[int]:
        """Rolling hash of every whole token block — the hash chain does
        not depend on lookup results, so all blocks can probe at once."""
        h, out = 0, []
        ps = self.page_size
        for b in range(len(tokens) // ps):
            h = _roll_hash(h, tokens[b * ps:(b + 1) * ps])
            out.append(h)
        return out

    def prefix_lookup(self, tokens: List[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix: returns (n_tokens_covered, page_ids)."""
        return self.prefix_lookup_many([tokens])[0]

    def prefix_lookup_many(self, prompts: List[List[int]], *,
                           assume_batch_ingest: bool = False
                           ) -> List[Tuple[int, List[Optional[int]]]]:
        """Longest cached prefixes for a whole admission batch through
        ONE read plan on the P-ART prefix cache; each prompt's match
        still ends at its first miss, exactly as the scalar walk did.
        This runs at admission (prefill), right after prefix ingest
        bumped the epoch — so adaptive dispatch is left on: forcing the
        kernel here would re-export the whole tree for a handful of
        hashes every admission.

        ``assume_batch_ingest`` gives sequential-admission hit
        semantics to a batched admission: every prompt ingests all its
        whole-block hashes, so a later prompt's walk also counts a
        block warm when an earlier prompt in this call is about to
        ingest it.  Such chain-hit blocks have no page yet — their
        page slots are ``None``."""
        all_hashes = [self._block_hashes(t) for t in prompts]
        plan = Plan()
        for hashes in all_hashes:
            for h in hashes:
                plan.get(h)
        if not len(plan):
            return [(0, []) for _ in prompts]
        res = self.prefix.execute(plan).results
        out, at = [], 0
        seen: set = set()
        for hashes in all_hashes:
            pages: List[Optional[int]] = []
            covered = 0
            for h, page in zip(hashes, res[at:at + len(hashes)]):
                if page is not None:
                    pages.append(page - 1)
                elif assume_batch_ingest and h in seen:
                    pages.append(None)
                else:
                    break
                covered += self.page_size
            at += len(hashes)
            if assume_batch_ingest:
                seen.update(hashes)
            out.append((covered, pages))
        return out

    def _ingest_ops(self, tokens: List[int], pages: List[int]
                    ) -> List[Tuple[int, int]]:
        """(hash, page+1) rows for every whole block of a prompt."""
        h, ps, ops = 0, self.page_size, []
        for b, page in enumerate(pages):
            blk = tokens[b * ps:(b + 1) * ps]
            if len(blk) < ps:
                break
            h = _roll_hash(h, blk)
            ops.append((h, page + 1))
        return ops

    def prefix_insert(self, tokens: List[int], pages: List[int]) -> int:
        """Ingest one prompt's whole-block hashes; see
        ``prefix_insert_many``.  Returns the number of blocks ingested."""
        return self.prefix_insert_many([(tokens, pages)])[0]

    def prefix_insert_many(self, batch: List[Tuple[List[int], List[int]]]
                           ) -> List[int]:
        """Ingest a whole admission batch's prefixes through ONE write
        plan on the sharded group-commit path: the prefix cache's
        snapshot is invalidated only in the shards the new hashes route
        to, so the next admission's prefix probe still serves every
        warm shard from the existing export.  Returns per-prompt block
        counts."""
        plan = Plan()
        counts = []
        for tokens, pages in batch:
            ops = self._ingest_ops(tokens, pages)
            for h, v in ops:
                plan.put(h, v)
            counts.append(len(ops))
        if len(plan):
            self.prefix.execute(plan, collect_results=False)
        return counts

    def recover(self) -> int:
        """Post-crash: locks were reinitialized by PMem.crash; the
        indexes need no repair (RECIPE).  Reconcile the bitmap against
        the block table + prefix cache (leaked pages = crash garbage),
        then warm the prefix cache's read path.  Returns the number of
        warm prefix blocks that survived."""
        live = set()
        for k, v in self.table.items():
            live.add(v - 1)
        for k, v in self.prefix.items():
            live.add(v - 1)
        for p in range(self.n_pages):
            if self.pmem.load(self.bitmap, p) == 1 and p not in live:
                self.free_page(p)
        return self.warm_prefixes()

    def warm_prefixes(self, chunk: int = 256) -> int:
        """Prefix-range warmup: sweep the surviving prefix cache with
        batched range scans (kernels/scan over the P-ART's sorted
        export), so the first admissions after a restart probe a warm
        snapshot instead of paying the export on the prefill path.
        Returns the number of warm prefix blocks found."""
        total, start = 0, 1
        while True:
            plan = Plan()
            plan.scan(start, chunk)
            rows = self.prefix.execute(plan, force_kernel=True).results[0]
            total += len(rows)
            if len(rows) < chunk:
                return total
            start = rows[-1][0] + 1


#: the cache leaves that hold one entry per token on axis -3
TOKEN_AXIS_CACHES = ("k", "v")


def _pad_caches(caches: Dict[str, Any], n: int, slots: int
                ) -> Dict[str, Any]:
    """Pad the attention caches' ``k`` and ``v`` along their token axis
    (-3) from the prompt's ``n`` tokens with zeros to ``slots``; every
    other leaf (RWKV's ``wkv``, ``shift_tm``, ``shift_cm``) is recurrent
    state and passes through.

    The JAX engine pads every leaf whose axis -3 equals ``n``: an RWKV
    state's axis -3 is its head count (``wkv`` [L, B, H, dh, dh]) or
    its layer count (the shifts [L, B, D]), so a prompt of exactly H or
    L tokens fails there (ROADMAP Queue 3, item 6).  Selecting by the
    leaf's key serves those prompts; on every other prompt, and on
    every dense-family cache, the two rules pad the same tensors."""
    out = {}
    for key, c in caches.items():
        if isinstance(c, dict):
            out[key] = _pad_caches(c, n, slots)
        elif key in TOKEN_AXIS_CACHES:
            shape = list(c.shape)
            shape[-3] = slots
            out[key] = c.new_zeros(shape)
            out[key][..., :n, :, :] = c
        else:
            out[key] = c
    return out


def check_serves(cfg) -> None:
    """Raise for Whisper (encoder-decoder) and InternVL (VLM): a
    request is its tokens, with no frames or patches, so the ``Server``
    cannot feed their encoder or projector.  They run at model level
    (``LM.prefill``, ``LM.decode_step`` with the encoder's output)."""
    if cfg is not None and takes_front_inputs(cfg):  # a stub's cfg is None
        raise NotImplementedError(
            f"the Server does not serve {cfg.name} ({cfg.family}): the JAX "
            "Server's prefill batch holds tokens only, with no frames or "
            "patches; run it at model level (LM.prefill, LM.decode_step)")


class Server:
    """Continuous-batching server over the port's ``LM``: on the model's
    device by default (``device=`` overrides; a model without
    parameters, as the stream tests pass, runs on the card unless the
    caller asks for the CPU).  Whisper and InternVL are refused
    (``check_serves``)."""

    def __init__(self, model, *, max_batch: int = 8,
                 page_size: int = 16, n_pages: int = 512,
                 pmem: Optional[PMem] = None, device=None):
        check_serves(model.cfg)
        self.model = model
        self.cfg = model.cfg
        if device is None:
            device = getattr(model, "device", None)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.page_size = page_size
        self.pmem = pmem or PMem()
        self.kv = PagedKVManager(self.pmem, n_pages, page_size,
                                 device=self.device)
        self.queue: List[Request] = []
        self.running: List[Request] = []
        self.caches: Dict[int, Any] = {}  # rid -> dense cache (compute)
        self.page_tables: Dict[int, List[Optional[int]]] = {}  # rid -> pages
        self._next_rid = 0
        # typed metrics registry; ``stats`` stays as a read-only dict
        # view over it so existing readers keep working
        self.metrics = MetricsRegistry()
        for name in ("prefill_tokens", "prefix_hits", "decode_steps",
                     "page_translations", "translation_batches",
                     "ingest_write_batches", "multi_session_ticks"):
            self.metrics.counter(name)
        from ..core.conditions import PROBE_STAT_KEYS
        for name in PROBE_STAT_KEYS:
            self.metrics.counter(name)
        # last-synced probe_stats image per PM index, so repeated syncs
        # fold only the delta (counters must sum exactly across merges)
        self._probe_synced = {id(ix): {k: 0 for k in PROBE_STAT_KEYS}
                              for ix in (self.kv.table, self.kv.prefix)}
        for name in ("warm_prefixes_restored", "prefix_shard_refined",
                     "sessions_connected", "pipeline_depth",
                     "admit_queue_depth"):
            self.metrics.gauge(name)
        for name in ("pipeline_prebuilt_plans", "pipeline_prebuilt_stale"):
            self.metrics.counter(name)
        # deferred snapshot re-exports (pipelined mode): registers the
        # async_exports_* counters and the async_export_backlog gauge
        self.exporter = AsyncExporter(metrics=self.metrics)
        # next tick's pre-built translation plan: (pairs, plan)
        self._prebuilt: Optional[Tuple[List[Tuple[int, int]], Plan]] = None
        self.stats = MetricsView(self.metrics)
        self._recover_t0: Optional[int] = None
        self._next_sid = 1  # 0 is the server's own default session
        self._rr_tick = 0  # rotating admission head across sessions

    def connect(self) -> "ServerSession":
        """Open a client session.  Each session submits independently;
        every tick's admission drains the sessions round-robin, so no
        single stream can starve the others (``ServerSession``)."""
        sid = self._next_sid
        self._next_sid += 1
        self.metrics.gauge("sessions_connected").set(self._next_sid - 1)
        return ServerSession(self, sid)

    def streams(self, n: int, *, collect_results: bool = True,
                lat_hist=None):
        """Multi-stream plan driver over the server's PM prefix index
        (``kv.prefix``), mirroring admission telemetry — above all the
        ``stream_deferred_plans`` contention counter — into
        ``Server.stats``.  The plan-level dual of ``connect()``:
        sessions race token requests, streams race raw index plans."""
        from ..distributed import StreamDriver
        return StreamDriver(self.kv.prefix, n,
                            collect_results=collect_results,
                            lat_hist=lat_hist, metrics=self.metrics)

    def submit(self, prompt: List[int], max_new: int = 16, *,
               sid: int = 0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new, sid=sid))
        return rid

    def _pop_admits(self, budget: int) -> List[Request]:
        """Pick up to ``budget`` queued requests, round-robin across
        the sessions present in the queue (per-session FIFO order, and
        the starting session rotates every tick).  With one session
        this is exactly the old global FIFO."""
        if budget <= 0 or not self.queue:
            return []
        by_sid: Dict[int, List[Request]] = {}
        for r in self.queue:
            by_sid.setdefault(r.sid, []).append(r)
        sids = sorted(by_sid)
        start = self._rr_tick % len(sids)
        self._rr_tick += 1
        admits: List[Request] = []
        i = 0
        while len(admits) < budget and any(by_sid.values()):
            q = by_sid[sids[(start + i) % len(sids)]]
            if q:
                admits.append(q.pop(0))
            i += 1
        picked = set(map(id, admits))
        self.queue = [r for r in self.queue if id(r) not in picked]
        if len({r.sid for r in admits}) > 1:
            self.metrics.counter("multi_session_ticks").inc()
        return admits

    def _admit(self, reqs: List[Request], max_len: int) -> List[Request]:
        """Admit a request batch with ONE plan per index: one read
        plan covering every request's prefix probes, one write plan
        for all their page grants, and one write plan for all their
        prefix ingests — admission metadata traffic no longer scales
        per request.  Intra-batch prefix reuse keeps its sequential-
        admission semantics (``prefix_lookup_many`` with
        ``assume_batch_ingest``).

        Admission is capacity-aware: page grants run first, and a
        request the pool cannot fully cover frees its partial allocs
        and returns to the queue head — its tick-mates still admit
        (the pre-plan engine raised and dropped the whole tick).
        Returns the requests actually admitted."""
        with _OBS.span("serve.admit", n_reqs=len(reqs)):
            return self._admit_inner(reqs, max_len)

    def _slots(self, max_len: int) -> int:
        """Slots of a dense cache: ``max_len`` rounded up to whole pages,
        so decode reads it as pages."""
        return -(-max_len // self.page_size) * self.page_size

    def _admit_inner(self, reqs: List[Request], max_len: int
                     ) -> List[Request]:
        pairs = [(r.rid, l) for r in reqs
                 for l in range(-(-len(r.prompt) // self.page_size))]
        have = self.kv.lookup_pages_batch(pairs, force_kernel=False)
        admitted: List[Request] = []
        requeued: List[Request] = []
        by_seq: List[Tuple[int, List[Tuple[int, int]]]] = []
        granted_by_rid: Dict[int, List[int]] = {}
        at = 0
        for req in reqs:
            n_logical = -(-len(req.prompt) // self.page_size)
            granted, grants = [], []
            for l, p in enumerate(have[at:at + n_logical]):
                if p is None:
                    p = self.kv.alloc_page()
                    if p is None:
                        break
                    grants.append((l, p))
                granted.append(p)
            at += n_logical
            if len(granted) < n_logical:  # pool exhausted mid-request
                for _, p in grants:
                    self.kv.free_page(p)
                requeued.append(req)
                continue
            admitted.append(req)
            by_seq.append((req.rid, grants))
            granted_by_rid[req.rid] = granted
        if requeued:
            self.queue[:0] = requeued
        if not admitted:
            return []
        matches = self.kv.prefix_lookup_many(
            [r.prompt for r in admitted], assume_batch_ingest=True)
        # per-request compute prefill + dense cache padding
        for req, (covered, _pages) in zip(admitted, matches):
            self.metrics.counter("prefix_hits").inc(covered)
            batch = {"tokens": torch.tensor([req.prompt], dtype=torch.int64,
                                            device=self.device)}
            logits, caches = self.model.prefill(batch, len(req.prompt))
            self.metrics.counter("prefill_tokens").inc(
                len(req.prompt) - covered)
            self.caches[req.rid] = _pad_caches(caches, len(req.prompt),
                                               self._slots(max_len))
            req.pos = len(req.prompt)
            req.out.append(int(torch.argmax(logits[0])))
        # one write plan per index for the whole admission
        self.kv.map_pages_many(by_seq)
        n_blocks = self.kv.prefix_insert_many(
            [(r.prompt, granted_by_rid[r.rid]) for r in admitted])
        n_grants = sum(len(g) for _, g in by_seq)
        self.metrics.counter("ingest_write_batches").inc(
            (n_grants > 0) + (sum(n_blocks) > 0))
        self.metrics.gauge("prefix_shard_refined").set(
            self.kv.prefix.shard_stats["refined_queries"])
        return admitted

    def _translation_pairs(self) -> List[Tuple[int, int]]:
        return [(req.rid, l) for req in self.running
                for l in range(-(-req.pos // self.page_size))]

    def _resolve_page_tables(self, *, pipelined: bool = False) -> None:
        """Translate every running sequence's logical pages in ONE
        batched probe of the block table (the decode hot path issues no
        scalar ``lookup`` at all).  The snapshot is epoch-cached inside
        the index, so steady decoding re-reads it for free and any
        grant/admission automatically forces a re-export.

        In pipelined mode the previous tick pre-built (and
        pre-scheduled) this plan at its tail; when the running set is
        unchanged the pre-built plan executes directly — identical ops,
        identical results — and an admission that changed the set just
        rebuilds (counted ``pipeline_prebuilt_stale``)."""
        pairs = self._translation_pairs()
        plan = None
        if pipelined and self._prebuilt is not None:
            built_pairs, built_plan = self._prebuilt
            self._prebuilt = None
            if built_pairs == pairs:
                plan = built_plan
                self.metrics.counter("pipeline_prebuilt_plans").inc()
            else:
                self.metrics.counter("pipeline_prebuilt_stale").inc()
        if plan is None:
            plan = self.kv.translation_plan(pairs)
        res = self.kv.table.execute(plan, force_kernel=True).results
        phys = [None if v is None else v - 1 for v in res]
        tables: Dict[int, List[Optional[int]]] = {r.rid: [] for r in self.running}
        for (rid, _), p in zip(pairs, phys):
            tables[rid].append(p)
        self.page_tables = tables
        self.metrics.counter("page_translations").inc(len(pairs))
        self.metrics.counter("translation_batches").inc()

    def step(self, max_len: int = 128, *, pipelined: bool = False) -> None:
        """One scheduler tick: admit + decode one token for all running.
        Admission drains the queue up to the batch limit and commits
        the whole admission's metadata with one plan per index.

        ``pipelined=True`` enables the double-buffered tick: snapshot
        re-exports dirtied by this tick's admission run as deferred
        jobs at the tick's *tail* (``AsyncExporter`` — epoch-guarded,
        so the next read wave serves either the old or the complete
        new export), and next tick's translation plan is pre-built and
        pre-scheduled while this tick's results are already out.
        Verified result-identical to the blocking path — only the
        placement of the export/build work moves."""
        with _OBS.span("serve.tick", queued=len(self.queue),
                       running=len(self.running)):
            self.metrics.gauge("admit_queue_depth").set(len(self.queue))
            admits = self._pop_admits(self.max_batch - len(self.running))
            served = False
            if admits:
                admitted = self._admit(admits, max_len)
                self.running.extend(admitted)
                served |= bool(admitted)
            if self.running:
                self._resolve_page_tables(pipelined=pipelined)
            finished = []
            with _OBS.span("serve.decode", width=len(self.running)):
                for req in self.running:
                    tok = torch.tensor([req.out[-1]], dtype=torch.int64,
                                       device=self.device)
                    pos = torch.tensor([req.pos], dtype=torch.int64,
                                       device=self.device)
                    logits, self.caches[req.rid] = self.model.decode_step(
                        tok, self.caches[req.rid], pos,
                        page_size=self.page_size)
                    self.metrics.counter("decode_steps").inc()
                    served = True
                    req.pos += 1
                    nxt = int(torch.argmax(logits[0]))
                    req.out.append(nxt)
                    if len(req.out) >= req.max_new or req.pos >= max_len - 1:
                        req.done = True
                        finished.append(req)
            for req in finished:
                self.running.remove(req)
                del self.caches[req.rid]
                self.page_tables.pop(req.rid, None)
            if served:
                self._first_service()
            if pipelined:
                self._pipeline_tail()
            self.sync_probe_stats()

    def _pipeline_tail(self) -> None:
        """Tail of a pipelined tick: run the deferred re-exports the
        tick dirtied (block table grants, prefix ingests) and pre-build
        next tick's translation plan — all after this tick's tokens are
        already out, so the next tick's read waves start warm."""
        with _OBS.span("serve.pipeline_tail"):
            self.exporter.submit_if_stale(self.kv.table)
            self.exporter.submit_if_stale(self.kv.prefix)
            self.exporter.run_pending()
            if self.running:
                pairs = self._translation_pairs()
                plan = self.kv.translation_plan(pairs)
                plan.arrays()
                plan.waves()
                self._prebuilt = (pairs, plan)
            else:
                self._prebuilt = None
            self.metrics.gauge("pipeline_depth").set(
                1 if self._prebuilt is not None else 0)

    def sync_probe_stats(self) -> None:
        """Fold the PM indexes' cumulative probe-traffic counters
        (fingerprint filter outcomes, modeled PM gather words, the
        optimistic read path's probe/retry tallies) into the server
        registry.  Delta-based against the last sync, so calling it
        any number of times — and merging the registry afterwards —
        still sums exactly."""
        for ix in (self.kv.table, self.kv.prefix):
            seen = self._probe_synced[id(ix)]
            for name, value in ix.probe_stats.items():
                delta = value - seen[name]
                if delta:
                    self.metrics.counter(name).inc(delta)
                    seen[name] = value

    def _first_service(self) -> None:
        """Close the recovery → first-token-served window: called on the
        first tick after ``crash_and_recover`` that emitted a token."""
        if self._recover_t0 is None:
            return
        t1 = time.perf_counter_ns()
        dt = t1 - self._recover_t0
        self.metrics.gauge("recovery_time_to_first_served_us").set(
            dt // 1000)
        _OBS.add_span("recovery.time_to_first_served", self._recover_t0, t1)
        self._recover_t0 = None

    def run_until_drained(self, max_len: int = 128,
                          max_ticks: int = 1000, *,
                          pipelined: bool = False) -> List[Request]:
        done: List[Request] = []
        ticks = 0
        while (self.queue or self.running) and ticks < max_ticks:
            before = {r.rid for r in self.running}
            self.step(max_len, pipelined=pipelined)
            ticks += 1
            done.extend(r for r in self.running if r.done)
        return done

    def crash_and_recover(self) -> None:
        """Power-fail the metadata plane; RECIPE indexes come back with
        no repair pass, the bitmap is reconciled, compute caches (HBM)
        are gone — but the block/prefix metadata for committed pages
        survives, so warm prefixes skip re-prefill.  Recovery ends with
        a prefix-range warmup pass (one batched scan sweep) so the
        first post-restart admissions probe a warm snapshot."""
        self._recover_t0 = time.perf_counter_ns()
        with _OBS.span("serve.recover"):
            # staged pipeline work dies with the power: queued re-export
            # jobs are discarded (the epoch guard would reject their
            # builds anyway — the crash count moved) and the pre-built
            # next-tick plan is dropped with the running set it assumed
            self.exporter.discard_pending()
            self._prebuilt = None
            self.pmem.crash(mode="powerfail")
            self.metrics.gauge("warm_prefixes_restored").set(
                self.kv.recover())
            self.caches.clear()
            self.running.clear()
            self.page_tables.clear()


class ServerSession:
    """One client's handle on a shared ``Server``: requests submitted
    here carry the session id, and the server's per-tick admission
    drains all connected sessions round-robin (``Server._pop_admits``)
    — many concurrent streams share one metadata plane without any
    stream starving the rest."""

    def __init__(self, server: Server, sid: int):
        self.server = server
        self.sid = sid

    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        return self.server.submit(prompt, max_new, sid=self.sid)

    @property
    def queued(self) -> int:
        return sum(r.sid == self.sid for r in self.server.queue)

    @property
    def running(self) -> List[Request]:
        return [r for r in self.server.running if r.sid == self.sid]

    def __repr__(self) -> str:
        return f"ServerSession(sid={self.sid}, queued={self.queued})"
