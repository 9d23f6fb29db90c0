"""The port's checkpoint store (repro_torch, ``device="cpu"``) against
the JAX package's.

The same tree, as JAX arrays on one side and as the port's tensors on
the other (a model's parameters through ``convert``), saved by both
stores writes the same PM image: the same manifest keys and values, the
same blob words and the same PMem counters.  Then the JAX tests' cases
(``test_framework.py``) on the port: a roundtrip, the latest generation
winning, a crash at any point of a save keeping the previous
generation, ``save_async`` and ``gc``; and the store's leaf limit
(reference limit R8: a leaf is one blob in one arena segment of
65,528 words) failing alike in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs import get_arch as jax_get_arch
from repro.core import CrashPoint as JCrashPoint
from repro.models.model import build_model as jax_build_model
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_arch
from repro_torch.convert import lm_arrays_from_params, lm_params_from_arrays
from repro_torch.core import CrashPoint, PMem


def small_tree(seed=0):
    """The JAX tests' tree: fp32, int32 and bf16 leaves, nested."""
    k = jax.random.PRNGKey(seed)
    return {
        "w1": jax.random.normal(k, (32, 16), jnp.float32),
        "nested": {"b": jnp.arange(7, dtype=jnp.int32),
                   "bf": jnp.ones((8, 8), jnp.bfloat16) * 1.5},
    }


def to_torch(tree):
    """A JAX tree's leaves as CPU tensors (bf16 stays bf16)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, tree)


def store():
    return CheckpointStore(device="cpu")


def same_image(tpm, jpm):
    assert vars(tpm.counters) == vars(jpm.counters)
    t = {r.name: r for r in tpm.regions.values()}
    j = {r.name: r for r in jpm.regions.values()}
    assert sorted(t) == sorted(j)
    for name in t:
        assert np.array_equal(t[name].cache, j[name].cache), name
        assert np.array_equal(t[name].pm, j[name].pm), name


def equal(a, b):
    return torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "minicpm-2b",
                                  "deepseek-moe-16b"])
def test_model_tree_writes_the_jax_stores_image(arch):
    """A model's parameters (bf16 weights, fp32 norms; groups stacked
    over repeats; DeepSeek's dense0, shared experts) saved over two
    generations, then restored and collected: manifest, blobs and PMem
    counters equal the JAX store's."""
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    tree = lm_arrays_from_params(
        lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg), cfg)
    ts, js = store(), JStore()
    for step in (4, 8):
        ts.save(step, tree)
        js.save(step, jp)
    same_image(ts.pmem, js.pmem)
    assert sorted(ts.manifest.items()) == sorted(js.manifest.items())
    got = ts.restore(tree, step=4)
    jgot = js.restore(jp, step=4)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree.leaves(jgot)):
        b = np.asarray(b)
        assert equal(a, to_torch(b)), jax.tree_util.keystr(path)
    assert ts.gc() == js.gc()
    same_image(ts.pmem, js.pmem)


def test_small_tree_writes_the_jax_stores_image():
    jt = small_tree()
    ts, js = store(), JStore()
    ts.save(10, to_torch(jt))
    js.save(10, jt)
    same_image(ts.pmem, js.pmem)


def test_numpy_leaves_save_like_tensors():
    tree = to_torch(small_tree())
    a, b = store(), store()
    a.save(1, tree)
    b.save(1, {"w1": tree["w1"].numpy(),
               "nested": {"b": tree["nested"]["b"].numpy(),
                          "bf": np.asarray(small_tree()["nested"]["bf"])}})
    same_image(a.pmem, b.pmem)


def test_roundtrip():
    s = store()
    tree = to_torch(small_tree())
    s.save(10, tree)
    got = s.restore(tree, step=10)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and equal(a, b)


def test_latest_generation_wins():
    s = store()
    t1, t2 = to_torch(small_tree(1)), to_torch(small_tree(2))
    s.save(1, t1)
    s.save(2, t2)
    assert s.latest_step() == 2
    assert torch.equal(s.restore(t2)["w1"], t2["w1"])
    assert torch.equal(s.restore(t1, step=1)["w1"], t1["w1"])


def test_no_generation_raises():
    with pytest.raises(FileNotFoundError):
        store().restore(to_torch(small_tree()))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.3, 0.6, 0.9, 0.99])
def test_crash_mid_save_keeps_previous_generation(frac):
    """A crash at any point of a save leaves the previous generation
    restorable, on both packages at the same crash point, with the same
    PM image after the crash."""
    t1, t2 = small_tree(1), small_tree(2)
    pmem = PMem()
    s = CheckpointStore(pmem, device="cpu")
    s.save(1, to_torch(t1))
    n0 = pmem.crash_calls
    s.save(2, to_torch(t2))
    n_points = pmem.crash_calls - n0
    stores = {}
    for side, (make, tree_of, crash_exc) in {
            "port": (lambda: CheckpointStore(PMem(), device="cpu"),
                     to_torch, CrashPoint),
            "jax": (lambda: JStore(), lambda t: t, JCrashPoint)}.items():
        st = make()
        st.save(1, tree_of(t1))
        st.pmem.arm_crash(after_stores=max(1, int(n_points * frac)))
        try:
            st.save(2, tree_of(t2))
            st.pmem.disarm_crash()
        except crash_exc:
            pass
        st.pmem.crash(mode="powerfail")
        assert st.latest_step() == 1
        stores[side] = st
    same_image(stores["port"].pmem, stores["jax"].pmem)
    got = stores["port"].restore(to_torch(t1), step=1)
    assert torch.equal(got["w1"], to_torch(t1)["w1"])


def test_save_async():
    s = store()
    tree = to_torch(small_tree())
    t = s.save_async(5, tree)
    tree["w1"].zero_()  # training goes on: the snapshot was taken
    t.join()
    got = s.restore(tree)
    assert torch.equal(got["w1"], to_torch(small_tree())["w1"])


def test_gc_reclaims_what_the_live_generation_does_not_reach():
    s, j = store(), JStore()
    for step in (1, 2):
        s.save(step, to_torch(small_tree(step)))
        j.save(step, small_tree(step))
    # a crashed save strands its blobs past the live generation's
    for st, tree, exc in ((s, to_torch(small_tree(3)), CrashPoint),
                          (j, small_tree(3), JCrashPoint)):
        st.pmem.arm_crash(after_stores=5)
        with pytest.raises(exc):
            st.save(3, tree)
        st.pmem.disarm_crash()
        st.pmem.crash(mode="powerfail")
    reclaimed = s.gc()
    assert reclaimed == j.gc() and reclaimed >= 0
    assert s.latest_step() == j.latest_step() == 2
    same_image(s.pmem, j.pmem)
    assert torch.equal(s.restore(to_torch(small_tree(2)))["w1"],
                       to_torch(small_tree(2))["w1"])


def test_a_leaf_over_one_segment_fails_in_both():
    """Reference limit R8: a blob lives in one arena segment, so a leaf
    of more than 65,528 words less its header cannot be saved, in
    either package (MiniCPM-2B's embedding alone is 141 M words)."""
    big = np.zeros(2 * 65529, np.float32)  # 65,529 words
    with pytest.raises(AssertionError):
        JStore().save(1, {"embed": jnp.asarray(big)})
    with pytest.raises(AssertionError):
        store().save(1, {"embed": torch.from_numpy(big)})
    ok = np.zeros(2 * (65528 - 5), np.float32)  # header of 4 + 1 words
    store().save(1, {"embed": torch.from_numpy(ok)})
