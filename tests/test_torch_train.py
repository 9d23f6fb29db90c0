"""The port's training slice (repro_torch, ``device="cpu"``) against the
JAX package: ``LM.loss`` and its gradients (attention, MoE, RWKV6, the
Mamba hybrid, Whisper's encoder and cross attention, InternVL's
projector), the train step over several steps, ``train`` with its crash
and restart, ``check_ported`` over every configuration, and the
entry points that refuse Whisper and InternVL.

The JAX package initialises each reduced configuration from
``PRNGKey(0)``; ``convert.lm_params_from_arrays`` carries its
parameters, cast to fp32, into the port's ``LM``, and both run the same
batches (drawn with numpy, or the token pipeline's).  Tolerances, the
same fp32 arithmetic in another order: the loss within 1e-5 of its
value; each parameter's gradient within 1e-4 of that leaf's largest
magnitude.  Over train steps: losses within 1e-4; the moments m and v
within 1e-4 of each leaf's largest; the parameters within 2 * lr plus
fp32 rounding, since AdamW's first step moves an element by +-lr and a
gradient element near 0 may take the other sign on the other side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import train as jax_train
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch
from repro_torch.convert import (adamw_state_from_arrays,
                                 lm_arrays_from_params,
                                 lm_params_from_arrays)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch import serve as tserve
from repro_torch.models import LM
from repro_torch.models.model import check_ported
from repro_torch.serving import Server

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def fp32_pair(arch, seed=0):
    """(JAX model, JAX fp32 params, port LM with the same fp32 weights,
    the port config)."""
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(seed)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from_arrays(to_np(jp), cfg), assign=True)
    return jm, jp, lm, cfg


def draw_batch(rng, cfg, B, T):
    """Tokens and next-token labels [B, T], and Whisper's ``frames`` or
    InternVL's ``patches`` (fp32 normals), drawn with numpy."""
    toks = rng.integers(0, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = rng.normal(size=(
            B, cfg.encdec.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = rng.normal(size=(
            B, cfg.vision.n_patches, cfg.vision.d_vit)).astype(np.float32)
    return batch


def rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max()) / max(
        float(np.abs(j).max()), 1e-30)


@pytest.mark.parametrize("arch,T", [("qwen2-0.5b", 24),
                                    ("minicpm-2b", 24),
                                    ("starcoder2-15b", 80),
                                    ("deepseek-moe-16b", 20),
                                    ("rwkv6-7b", 37),
                                    ("jamba-1.5-large-398b", 37),
                                    ("whisper-tiny", 20),
                                    ("internvl2-76b", 20)],
                         ids=["qwen2", "minicpm", "starcoder2-window",
                              "deepseek-moe", "rwkv6", "jamba-hybrid",
                              "whisper", "internvl"])
def test_loss_and_grads_match_jax(arch, T):
    """Qwen2 (tied head, qkv biases), MiniCPM (untied head), StarCoder2
    (LayerNorm, GELU; T = 80 past its reduced window of 64, so the
    window masks keys), DeepSeek-MoE (a dense layer 0, shared experts,
    the aux loss in the objective), RWKV6 (the WKV scan and its
    backward, the channel mix; T = 37 over the JAX chunk of 16, ragged),
    the Jamba hybrid (Mamba mixers' SSD scan and its backward,
    attention, MLP and MoE; T = 37 ragged over the chunk of 16), Whisper
    (the encoder's non-causal attention over 32 frames and the decoder's
    cross attention, T = 20 against S = 32, both through the attention
    backward; the encoder stacked on axis 0) and InternVL (16 projected
    patches before the text, one kv head for four query heads; the loss
    over the text positions only)."""
    jm, jp, lm, cfg = fp32_pair(arch)
    if arch == "starcoder2-15b":
        assert cfg.sliding_window == 64 < T
    batch = draw_batch(np.random.default_rng(5), cfg, 2, T)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.loss(tbatch)
    logits, aux = lm.forward(tbatch)
    if cfg.moe is None:
        assert aux.item() == 0.0
    else:
        assert aux.item() > 0.0
    assert logits.shape == (2, T, cfg.vocab)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    loss.backward()
    want = lm_params_from_arrays(to_np(jgrads), cfg)
    got = {k: p.grad for k, p in lm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g is not None and g.shape == want[name].shape, name
        assert rel(g, want[name].numpy()) <= GRAD_TOL, name


def steps_match_jax(arch, steps):
    """``steps`` train steps from carried-across fp32 params and
    optimizer state, on the pipelines' batches, against the JAX jit
    step: losses, moments and parameters."""
    jm, jp, lm, cfg = fp32_pair(arch)
    dcfg = dict(vocab=cfg.vocab, seq_len=32, global_batch=2, n_docs=64,
                mean_doc_len=64, seed=0)
    tdata = TokenPipeline(DataConfig(**dcfg), device="cpu")
    jdata = JTokenPipeline(JDataConfig(**dcfg))
    jstep = jax.jit(jax_make_train_step(jm, cfg.name, total_steps=steps))
    tstep = make_train_step(lm, cfg.name, total_steps=steps)
    js = jadamw.init(jp)
    ts = adamw_state_from_arrays(jax.tree.map(np.asarray, js), cfg)
    assert ts.step == 0 and sorted(ts.m) == sorted(dict(lm.named_parameters()))
    for i in range(steps):
        tb, jb = tdata.next_batch(), jdata.next_batch()
        assert np.array_equal(tb["tokens"], jb["tokens"])
        jp, js, jloss = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in jb.items()})
        tloss, ts = tstep({k: torch.from_numpy(v) for k, v in tb.items()},
                          ts)
        tdata.commit()
        jdata.commit()
        assert ts.step == int(js.step) == i + 1
        assert abs(float(tloss) - float(jloss)) <= STEP_TOL * \
            abs(float(jloss)), i
    lr = 3e-4
    params = lm_params_from_arrays(to_np(jp), cfg)
    for part in ("m", "v"):
        want = lm_params_from_arrays(to_np(getattr(js, part)), cfg)
        for name, t in getattr(ts, part).items():
            assert rel(t, want[name].numpy()) <= STEP_TOL, (part, name)
    for name, p in lm.named_parameters():
        assert p.grad is None  # freed after the step
        diff = (p.detach() - params[name]).abs()
        limit = 2 * lr + 1e-6 * params[name].abs().max()
        assert bool((diff <= limit).all()), name


def test_train_steps_match_jax():
    """Five steps of MiniCPM (WSD) against the JAX jit step."""
    steps_match_jax("minicpm-2b", 5)


def test_rwkv6_train_steps_match_jax():
    """Four steps of RWKV6 (cosine; the WKV scan and its backward, T = 32
    over the reduced chunk of 16) against the JAX jit step."""
    steps_match_jax("rwkv6-7b", 4)


def test_train_with_injected_crash_restart_matches_jax():
    """The JAX test's run on the port: restart from the last committed
    generation (step 4) at the committed data cursor (step 6); the
    store's (its manifest and superblock; the blobs hold each run's own
    weights) and the ledger's PMem words and counters equal the JAX
    run's."""
    kw = dict(steps=12, batch=4, seq_len=32, ckpt_every=4, kill_at_step=6,
              verbose=False)
    out = ttrain.train("qwen2-0.5b", device="cpu", **kw)
    jout = jax_train("qwen2-0.5b", **kw)
    assert out["final_step"] == jout["final_step"] == 12
    assert out["data"].global_step == jout["data"].global_step == 12
    assert len(out["losses"]) == len(jout["losses"]) == 6
    assert np.isfinite(out["losses"]).all()
    tpm, jpm = out["store"].pmem, jout["store"].pmem
    assert vars(tpm.counters) == vars(jpm.counters)
    t = {r.name: r for r in tpm.regions.values()}
    j = {r.name: r for r in jpm.regions.values()}
    assert sorted(t) == sorted(j)
    for name in t:
        if name.startswith("ckpt.seg"):
            continue  # blob words: the two runs' weights differ
        assert np.array_equal(t[name].pm, j[name].pm), name
    assert out["store"].latest_step() == jout["store"].latest_step() == 12
    # the committed generation is the live parameters, bit for bit
    cfg = get_arch("qwen2-0.5b").reduced()
    live = lm_arrays_from_params(out["params"], cfg)
    got = out["store"].restore(live, step=12)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(live)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "rwkv6-7b",
                                  "whisper-tiny", "internvl2-76b"])
def test_lm_arrays_from_params_is_the_jax_tree(arch):
    """The inverse of ``lm_params_from_arrays``: the JAX package's tree,
    leaf for leaf (groups stacked over repeats, ``moe.shared``;
    Whisper's ``encoder`` stacked, ``enc_norm``, ``ln3`` and ``cross``;
    InternVL's ``projector``)."""
    cfg, jcfg = get_arch(arch).reduced(), jax_get_arch(arch).reduced()
    jp = to_np(jax_build_model(jcfg).init_params(jax.random.PRNGKey(1)))
    tree = lm_arrays_from_params(lm_params_from_arrays(jp, cfg), cfg)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
        assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_train_and_serve_refuse_encdec_and_vlm(arch, monkeypatch):
    """The token pipeline and the ``Server``'s requests hold tokens only
    (as the JAX ``train()`` and ``Server`` do): ``train()``, ``serve()``
    and ``Server(...)`` refuse Whisper and InternVL, each with its own
    message, before any weight is drawn."""
    built = []
    for mod in (ttrain, tserve):
        monkeypatch.setattr(mod, "build_model",
                            lambda *a, **k: built.append(1))
    with pytest.raises(NotImplementedError, match="token pipeline feeds "
                       "tokens only"):
        ttrain.train(arch, steps=1, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="prefill batch holds "
                       "tokens only"):
        tserve.serve(arch, reduced=True, device="cpu", verbose=False)
    assert not built
    lm = LM(dataclasses.replace(get_arch(arch).reduced(), n_layers=1),
            device="cpu")
    with pytest.raises(NotImplementedError, match="prefill batch holds "
                       "tokens only"):
        Server(lm, page_size=8, n_pages=32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "minicpm-2b",
                                  "starcoder2-15b", "deepseek-moe-16b",
                                  "mixtral-8x22b", "codeqwen1.5-7b",
                                  "rwkv6-7b", "jamba-1.5-large-398b",
                                  "whisper-tiny", "internvl2-76b"])
def test_check_ported_takes_every_configuration(arch):
    """Every configuration of the registry runs and trains, at full
    width and at ``reduced()``; a layer-kind set the port does not know
    still raises."""
    check_ported(get_arch(arch))
    check_ported(get_arch(arch).reduced())
    # Mamba and attention layers with no MoE: a set no family has
    odd = dataclasses.replace(get_arch("qwen2-0.5b").reduced(),
                              attn_every=2, mamba=get_arch(
                                  "jamba-1.5-large-398b").mamba)
    with pytest.raises(NotImplementedError, match="does not run"):
        check_ported(odd)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "deepseek-moe-16b",
                                  "codeqwen1.5-7b"])
def test_full_width_training_refused_over_the_card(arch, monkeypatch):
    """16 bytes a parameter over 80 GB: refused before the model is
    built."""
    built = []
    monkeypatch.setattr(ttrain, "build_model",
                        lambda *a, **k: built.append(1))
    with pytest.raises(NotImplementedError, match="does not fit one card"):
        ttrain.train(arch, reduced=False, steps=1, device="cpu",
                     verbose=False)
    assert not built


def test_minicpm_and_qwen2_fit_the_card():
    for arch, n in (("minicpm-2b", 3_007_701_504), ("qwen2-0.5b", None)):
        cfg = get_arch(arch)
        ttrain.check_fits_training(cfg)
        if n is not None:
            assert cfg.param_count() == n
            assert 16 * n / 1e9 == pytest.approx(48.1, abs=0.05)


def test_prefill_and_decode_steps_run_the_model():
    cfg = get_arch("qwen2-0.5b").reduced()
    lm = LM(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, 16)))
    logits, caches = make_prefill_step(lm, 16)({"tokens": toks})
    want, _ = lm.prefill({"tokens": toks}, 16)
    assert torch.equal(logits, want)
    cache = lm.init_caches(1, 32)
    out, _ = make_decode_step(lm)(toks[:, 0], cache,
                                  torch.zeros(1, dtype=torch.int64))
    assert out.shape == (1, cfg.vocab)


def test_training_leaves_serving_frozen_and_no_grad():
    """A model is created frozen; a train step turns its parameters
    trainable; prefill still records no graph."""
    cfg = dataclasses.replace(get_arch("qwen2-0.5b").reduced(), n_layers=1)
    lm = LM(cfg, device="cpu")
    assert not any(p.requires_grad for p in lm.parameters())
    make_train_step(lm, cfg.name)
    assert all(p.requires_grad for p in lm.parameters())
    logits, _ = lm.prefill({"tokens": torch.zeros(1, 4, dtype=torch.int64)},
                           4)
    assert logits.grad_fn is None
