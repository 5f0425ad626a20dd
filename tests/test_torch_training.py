"""samd_tpu_torch.training against samd_tpu.training, on shared weights
(CPU, f32, tiny config): the Markov corpus token for token, the LM and
EAGLE distillation losses within 1e-5 relative and their gradients within
1e-4 of ``jax.grad``'s, the learning-rate schedule against optax's at every
step, twelve steps of ``train_lm`` and ``train_eagle`` (the warmup and
the start of the cosine) whose losses and parameters stay within 1e-4 of
optax's AdamW, and three of ``make_lm_train_step`` against JAX's jitted
step within the same 1e-4.  Then the trained models' accept lengths, as
``tests/test_training.py`` holds JAX's, the accept demo at a small size,
and the kernels' gradient guard."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samd_tpu import training as jax_training
from samd_tpu.drafters.eagle.net import EagleNetConfig as JaxNetCfg
from samd_tpu.drafters.eagle.net import init_eagle_params as jax_init_net
from samd_tpu.models import init_params, tiny_config
from samd_tpu_torch import training
from samd_tpu_torch.bridge import eagle_params_from_jax, params_from_jax
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.device import refuse_grad
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.drafters.eagle.net import EagleNetConfig
from samd_tpu_torch.engine import SamdEngine
from samd_tpu_torch.models import tiny_config as port_tiny
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import port_config

VOCAB = 48


def leaves(tree):
    """A parameter dict's leaves in JAX's tree order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


@pytest.fixture(scope="module")
def shared():
    """JAX's tiny model and draft net, and their bridged copies."""
    jcfg = tiny_config(vocab_size=VOCAB)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    jnet = jax_init_net(JaxNetCfg.from_target(jcfg), jax.random.PRNGKey(1))
    corpus = jax_training.markov_corpus(VOCAB, 3000, seed=0)
    return (jcfg, jp, jnet, port_config(jcfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            eagle_params_from_jax(jax.tree.map(np.asarray, jnet), "cpu"),
            corpus)


@pytest.mark.parametrize("kw", [dict(order=2, seed=0),
                                dict(order=1, seed=7, branch=3, peak=0.8)])
def test_markov_corpus_equals_jax(kw):
    want = jax_training.markov_corpus(VOCAB, 4000, **kw)
    got = training.markov_corpus(VOCAB, 4000, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_schedule_equals_optax():
    for lr, steps in ((3e-3, 200), (1e-3, 400), (3e-3, 12)):
        want = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=max(steps // 20, 10), decay_steps=steps,
            end_value=lr * 0.1)
        at = training.lr_schedule(lr, steps)
        for i in range(steps + 5):
            assert at(i) == pytest.approx(float(want(i)), rel=1e-6,
                                          abs=1e-12), (lr, steps, i)
    with pytest.raises(ValueError, match="warmup"):
        training.lr_schedule(3e-3, 10)


def test_lm_loss_and_grad_equal_jax(shared):
    jcfg, jp, _, cfg, params, _, corpus = shared
    toks = corpus[:8 * 24].reshape(8, 24)
    jl, jg = jax.value_and_grad(
        lambda p: jax_training.lm_loss(p, jcfg, jnp.asarray(toks)))(jp)
    p, ls = training._trainable(params)
    loss = training.lm_loss(p, cfg, torch.from_numpy(toks.astype(np.int64)))
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for a, b in zip(jax.tree.leaves(jg), leaves(p)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=1e-4)


def test_eagle_loss_and_grad_equal_jax(shared):
    jcfg, jp, jnet, cfg, params, net, corpus = shared
    toks = corpus[100:100 + 8 * 24].reshape(8, 24)
    jl, jg = jax.value_and_grad(lambda n: jax_training.eagle_distill_loss(
        n, JaxNetCfg.from_target(jcfg), jcfg, jp, jnp.asarray(toks)))(jnet)
    n, _ = training._trainable(net)
    loss = training.eagle_distill_loss(
        n, EagleNetConfig.from_target(cfg), cfg, params,
        torch.from_numpy(toks.astype(np.int64)))
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for k in jg:
        np.testing.assert_allclose(n[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-4, err_msg=k)


def test_train_lm_steps_equal_optax(shared):
    jcfg, jp, _, cfg, params, _, corpus = shared
    kw = dict(steps=12, batch=4, seq_len=24, seed=0, log_every=1)
    # JAX's step donates its parameters: hand it a copy
    jparams, jlosses = jax_training.train_lm(
        jcfg, corpus, params=jax.tree.map(jnp.copy, jp), **kw)
    got, losses = training.train_lm(cfg, corpus, params=params,
                                    device="cpu", **kw)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    for a, b in zip(jax.tree.leaves(jparams), leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
        assert not b.requires_grad
    # the caller's parameters are copied, not trained in place
    assert torch.equal(params["embed"],
                       torch.from_numpy(np.array(jp["embed"])))


def test_make_lm_train_step_equals_jax(shared):
    """Three steps of the one-step closure against JAX's jitted step, both
    under AdamW at a constant learning rate: losses and parameters within
    1e-4."""
    jcfg, jp, _, cfg, params, _, corpus = shared
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    jstep = jax_training.make_lm_train_step(jcfg, tx)
    jparams = jax.tree.map(jnp.copy, jp)    # JAX's step donates them
    jstate = tx.init(jparams)
    p, ls = training._trainable(params)
    opt = torch.optim.AdamW(ls, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = training.make_lm_train_step(
        dataclasses.replace(cfg, attention_impl="flash"), opt)
    for i in range(3):
        toks = corpus[i * 96:(i + 1) * 96].reshape(4, 24)
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(toks))
        loss = step(p, torch.from_numpy(toks.astype(np.int64)))
        assert not loss.requires_grad
        assert loss.item() == pytest.approx(float(jl), abs=1e-4)
    for a, b in zip(jax.tree.leaves(jparams), leaves(p)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-4)


def test_train_eagle_steps_equal_optax(shared):
    jcfg, jp, jnet, cfg, params, net, corpus = shared
    kw = dict(steps=12, batch=4, seq_len=24, seed=0)
    jn, jlosses = jax_training.train_eagle(
        jcfg, jp, corpus, net_params=jax.tree.map(jnp.copy, jnet), **kw)
    seen = []
    got, losses = training.train_eagle(
        cfg, params, corpus, net_params=net, device="cpu",
        on_step=lambda i, loss, ls: seen.append(
            (i, loss, all(t.grad is not None for t in ls))), **kw)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    for k in jn:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jn[k]),
                                   atol=1e-4, err_msg=k)
    assert [s[0] for s in seen] == list(range(12)) and all(s[2] for s in seen)


def test_training_sets_plain_attention(shared, monkeypatch):
    """train_lm trains through the plain attention whatever the caller's
    config says: the kernels have no backward."""
    _, _, _, cfg, params, _, corpus = shared
    seen = []
    real = training.lm_loss

    def spy(p, c, toks):
        seen.append(c.attention_impl)
        return real(p, c, toks)

    monkeypatch.setattr(training, "lm_loss", spy)
    training.train_lm(dataclasses.replace(cfg, attention_impl="flash"),
                      corpus, params=params, steps=11, batch=1, seq_len=16,
                      device="cpu")
    assert seen and set(seen) == {"xla"}


# ---------------------------------------------------------------------------
# trained models accept, as tests/test_training.py holds JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    cfg = port_tiny(vocab_size=VOCAB)
    corpus = training.markov_corpus(VOCAB, 12000, seed=0)
    params, lm_losses = training.train_lm(cfg, corpus, steps=200, batch=8,
                                          seq_len=48, seed=0, log_every=199,
                                          device="cpu")
    net, eg_losses = training.train_eagle(cfg, params, corpus, steps=200,
                                          batch=8, seq_len=48, seed=0,
                                          device="cpu")
    return cfg, corpus, params, lm_losses, net, eg_losses


def _accept(cfg, params, scfg, prompts, gen, **kw):
    eng = SamdEngine(cfg, params, scfg,
                     make_drafter(scfg, cfg.vocab_size, model_cfg=cfg,
                                  params=params, **kw),
                     max_cache_len=256, eos_token_id=-1,
                     prefill_buckets=(32,), device="cpu")
    tok = steps = 0
    for p in prompts:
        o = eng.generate(p, gen)
        tok += o.decode_tokens
        steps += o.decode_steps
    return tok / max(steps, 1)


def test_lm_training_reduces_loss(trained):
    _, _, _, lm_losses, _, _ = trained
    assert lm_losses[-1] < 0.5 * lm_losses[0], lm_losses
    assert lm_losses[-1] < 1.5


def test_trained_eagle_beats_random_net(trained):
    cfg, corpus, params, _, net, eg_losses = trained
    assert eg_losses[-1] < 3.0
    scfg = SamdConfig(draft_source="sam_hybrid", tree_method="eagle2",
                      max_predicts=16, len_threshold=1000,
                      eagle_depth=3, eagle_topk=4, eagle_total_tokens=15)
    gen = GenerationConfig(max_new_tokens=32, max_cache_len=256)
    prompts = [corpus[s:s + 24].tolist() for s in (500, 6000)]
    acc_trained = _accept(cfg, params, scfg, prompts, gen,
                          eagle_net_params=net)
    acc_random = _accept(cfg, params, scfg, prompts, gen)
    assert acc_trained > 1.5
    assert acc_trained > 1.2 * acc_random


def test_sam_retrieval_accept_on_trained_model(trained):
    cfg, corpus, params, _, _, _ = trained
    from samd_tpu_torch.sam import build_corpus_sam

    sam = build_corpus_sam([corpus.tolist()], eos_token=0, topk=8)
    scfg = SamdConfig(draft_source="sam_only", max_predicts=40, alpha=4.0)
    gen = GenerationConfig(max_new_tokens=40, max_cache_len=256)
    prompts = [corpus[s:s + 24].tolist() for s in (900, 7000)]
    assert _accept(cfg, params, scfg, prompts, gen, static_sam=sam) > 2.5


def test_accept_demo_small():
    """The accept demo end to end at a small size: train, save, load, and
    every drafter row measured."""
    from samd_tpu_torch.evaluation.accept_demo import run

    out = run(steps=25, vocab=32, new_tokens=16, device="cpu")
    assert out["lm_loss"] < out["lm_loss_first"]
    assert set(out["accept"]) == {
        "sam_only_trained", "sam_only_dyn_trained", "token_recycle_trained",
        "token_recycle_trained_order1", "eagle2_trained",
        "eagle2_random_net", "sam_eagle2_trained", "eagle2_trained_batched"}
    assert all(v >= 1.0 for v in out["accept"].values())
    assert out["reference_targets"]["eagle2_mean_accept"] == 4.62


# ---------------------------------------------------------------------------
# the gradient guard
# ---------------------------------------------------------------------------

def test_refuse_grad_check():
    """The check each kernel wrapper runs on the card: an input that
    requires grad while grad mode is on raises; under no_grad, or with
    inputs that need none, it passes."""
    w = torch.zeros(4, requires_grad=True)
    x = torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", x, None, w)
    refuse_grad("k", x, None)
    with torch.no_grad():
        refuse_grad("k", x, w)


def test_plain_versions_keep_gradients():
    """On the CPU the wrappers take their plain versions, which autograd
    sees through: the verify attention's q gets a gradient."""
    from samd_tpu_torch.models.llama import prefill_mask
    from samd_tpu_torch.ops.flash_attention import flash_block_attention

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 16, generator=g, requires_grad=True)
    k, v = torch.randn(2, 1, 1, 8, 16, generator=g)
    out = flash_block_attention(q, k, v, prefill_mask(1, 4, 8).contiguous(),
                                torch.tensor(4, dtype=torch.int32))
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
