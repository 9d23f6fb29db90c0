"""The port's token pipeline (repro_torch, ``device="cpu"``) against
the JAX package's: the same config and seed give the same batches bit
for bit, the same cursor, the same ledger entries and the same PMem
words and counters; and the JAX tests' cases (``test_framework.py``)
run on the port."""

import numpy as np
import pytest

from repro.core import PMem as JPMem
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro_torch.core import PMem
from repro_torch.data.pipeline import DataConfig, TokenPipeline

CFG = dict(vocab=100, seq_len=16, global_batch=4, n_docs=64,
           mean_doc_len=64)


def pm_image(pmem):
    return {r.name: (r.cache.copy(), r.pm.copy())
            for r in pmem.regions.values()}


def same_pm(tp, jp):
    assert vars(tp.pmem.counters) == vars(jp.pmem.counters)
    t_img, j_img = pm_image(tp.pmem), pm_image(jp.pmem)
    assert sorted(t_img) == sorted(j_img)
    for name in t_img:
        for a, b in zip(t_img[name], j_img[name]):
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("cfg", [
    CFG,
    dict(vocab=512, seq_len=32, global_batch=4, n_docs=256,
         mean_doc_len=128, seed=0),      # the train test's pipeline
    dict(vocab=122753, seq_len=64, global_batch=8, n_docs=256,
         mean_doc_len=128, seed=3),      # MiniCPM-2B's vocabulary
])
def test_batches_cursor_ledger_and_pm_match_jax(cfg):
    tp = TokenPipeline(DataConfig(**cfg), device="cpu")
    jp = JTokenPipeline(JDataConfig(**cfg))
    assert tp.n_seq == jp.n_seq and tp.steps_per_epoch == jp.steps_per_epoch
    assert np.array_equal(tp.packed, jp.packed)
    # past an epoch boundary
    for _ in range(tp.steps_per_epoch + 3):
        tb, jb = tp.next_batch(), jp.next_batch()
        for key in ("tokens", "labels"):
            assert tb[key].dtype == jb[key].dtype == np.int32
            assert np.array_equal(tb[key], jb[key])
        tp.commit()
        jp.commit()
        assert tp.cursor == jp.cursor
        assert tp.global_step == jp.global_step
    assert tp.cursor[0] == jp.cursor[0] == 1
    assert sorted(tp.ledger.items()) == sorted(jp.ledger.items())
    same_pm(tp, jp)


def test_crash_between_commits_matches_jax():
    tp = TokenPipeline(DataConfig(**CFG), device="cpu")
    jp = JTokenPipeline(JDataConfig(**CFG))
    for p in (tp, jp):
        for _ in range(3):
            p.next_batch()
            p.commit()
        p.pmem.crash(mode="powerfail")
        p.recover()
        assert p.cursor[1] == 3  # the committed cursor survives exactly
    same_pm(tp, jp)


def test_deterministic_and_resumable():
    """The JAX test's case on the port: a fresh pipeline on the same PM
    resumes at the committed step; one on fresh PM replays from 0."""
    cfg = DataConfig(**CFG)
    p1 = TokenPipeline(cfg, device="cpu")
    seen = []
    for _ in range(5):
        seen.append(p1.next_batch()["tokens"].copy())
        p1.commit()
    p2 = TokenPipeline(cfg, pmem=p1.pmem, device="cpu")
    assert p2.cursor == p1.cursor
    b5 = p2.next_batch()["tokens"]
    p3 = TokenPipeline(cfg, device="cpu")
    for i in range(5):
        assert np.array_equal(p3.next_batch()["tokens"], seen[i]), i
        p3.commit()
    assert np.array_equal(p3.next_batch()["tokens"], b5)


def test_rank_stripes_disjoint_and_match_jax():
    cfg = dict(CFG, global_batch=8)
    for rank in (0, 1):
        t = TokenPipeline(DataConfig(**cfg), rank=rank, world=2,
                          device="cpu")
        j = JTokenPipeline(JDataConfig(**cfg), rank=rank, world=2)
        assert np.array_equal(t.next_batch()["tokens"],
                              j.next_batch()["tokens"])
    a = TokenPipeline(DataConfig(**cfg), rank=0, world=2,
                      device="cpu").next_batch()["tokens"]
    b = TokenPipeline(DataConfig(**cfg), rank=1, world=2,
                      device="cpu").next_batch()["tokens"]
    assert a.shape[0] == b.shape[0] == 4
    assert not np.array_equal(a, b)


def test_shared_pm_with_a_store_matches_jax():
    """The trainer's layout: the pipeline on a PM that already holds
    other regions (the checkpoint store's) allocates the same ids."""
    tpm, jpm = PMem(), JPMem()
    tpm.alloc("other", 64)
    jpm.alloc("other", 64)
    tp = TokenPipeline(DataConfig(**CFG), pmem=tpm, device="cpu")
    jp = JTokenPipeline(JDataConfig(**CFG), pmem=jpm)
    for p in (tp, jp):
        p.next_batch()
        p.commit()
    same_pm(tp, jp)
