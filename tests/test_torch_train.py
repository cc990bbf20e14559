"""The port's train step against ``modelx_tpu/models/train.py`` on the CPU.

``LlamaConfig.tiny`` in fp32: the JAX package's ``init_params`` go to the
port through ``dl/weights.from_jax_params``; both packages take three AdamW
steps on the same numpy batches. Held, fp32 (the two frameworks sum in
other orders):
- the losses within 2e-6 relative, and every parameter's first-step
  gradient (none None) within 1e-6 of its tensor's largest entry, plus 1e-5
  relative;
- the params after three steps within 2e-6, but for at most 1 element in
  10,000, which must lie within 3 x lr (9e-4): an element whose gradient is
  at Adam's eps scale (~1e-8) takes a step of lr * g / (|g| + eps), so a
  summation-order difference in g moves it by a fraction of lr (3 of
  328,320 elements here, all with first-step |g| < 4e-8);
- the moments within 1e-4 of each tensor's largest entry: steps 2 and 3
  see the params those few elements moved; the count exactly;
- ``cross_entropy_loss`` and ``load_balancing_loss`` within 1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.models import llama as jllama
from modelx_tpu.models import train as jtrain
from modelx_tpu.ops import moe as jmoe
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tllama
from modelx_tpu_torch.models import train as ttrain
from modelx_tpu_torch.ops import moe as tmoe

STEPS = 3
LR = 3e-4


def _cfgs(vocab=128):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=vocab), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=vocab), dtype=torch.float32)
    return jcfg, tcfg


def _batches(vocab, n=STEPS, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": w[:, :-1], "targets": w[:, 1:]})
    return out


def _close(got, want, rel_of_max, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = rel_of_max * np.abs(want).max() + rtol * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), (what, float(np.abs(got - want).max()))


@pytest.fixture(scope="module")
def three_steps():
    jcfg, tcfg = _cfgs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    batches = _batches(jcfg.vocab_size)

    jopt = jtrain.make_optimizer(lr=LR)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt))

    def jloss(p, batch):
        logits, _ = jllama.forward(p, batch["tokens"], jcfg)
        return jtrain.cross_entropy_loss(logits, batch["targets"])

    jgrads = jax.grad(jloss)(jparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
    jlosses = []
    for batch in batches:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jparams, jstate, loss = jstep(jparams, jstate, jbatch)
        jlosses.append(float(loss))

    tparams = from_jax_params(np_params, device="cpu")
    topt = ttrain.make_optimizer(lr=LR)
    tstate = topt.init(tparams)
    tstep = ttrain.make_train_step(tcfg, topt)

    def tforward(p, tokens):
        return tllama.forward(p, tokens, tcfg)[0]

    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    _, tgrads = ttrain.loss_and_grads(tparams, tbatches[0], tforward)
    tlosses = []
    for batch in tbatches:
        tparams, tstate, loss = tstep(tparams, tstate, batch)
        tlosses.append(float(loss))
    return {"jgrads": jgrads, "tgrads": tgrads, "jlosses": jlosses, "tlosses": tlosses,
            "jparams": jparams, "jstate": jstate, "tparams": tparams, "tstate": tstate}


def test_losses_agree(three_steps):
    np.testing.assert_allclose(three_steps["tlosses"], three_steps["jlosses"], rtol=2e-6)
    assert three_steps["tlosses"][-1] < three_steps["tlosses"][0] * 1.05  # finite, sane


def test_every_gradient_agrees_and_none_is_missing(three_steps):
    tgrads, jgrads = three_steps["tgrads"], three_steps["jgrads"]
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        assert g is not None, name
        _close(g.numpy(), np.asarray(jgrads[name]), 1e-6, 1e-5, name)


def test_params_and_moments_after_three_steps_agree(three_steps):
    jparams, jstate = three_steps["jparams"], three_steps["jstate"]
    tparams, tstate = three_steps["tparams"], three_steps["tstate"]
    adam = jstate[0]
    assert int(tstate.count) == int(adam.count) == STEPS
    off = total = 0
    for name, p in tparams.items():
        gap = np.abs(p.detach().numpy() - np.asarray(jparams[name]))
        assert gap.max() <= STEPS * LR, name
        off += int((gap > 2e-6).sum())
        total += gap.size
        _close(tstate.mu[name].numpy(), np.asarray(adam.mu[name]), 1e-4, 0.0, f"mu {name}")
        _close(tstate.nu[name].numpy(), np.asarray(adam.nu[name]), 1e-4, 0.0, f"nu {name}")
    assert off <= total // 10_000, (off, total)


def test_cross_entropy_and_load_balancing_losses_agree():
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 7, 33).astype(np.float32) * 3
    targets = rng.randint(0, 33, (2, 7)).astype(np.int32)
    want = float(jtrain.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(ttrain.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)

    router = rng.randn(2, 9, 8).astype(np.float32)
    mask = (rng.rand(2, 9, 8) < 0.25).astype(np.float32)
    want = float(jmoe.load_balancing_loss(jnp.asarray(router), jnp.asarray(mask)))
    got = float(tmoe.load_balancing_loss(torch.from_numpy(router), torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)


def test_a_mesh_or_a_cut_graph_raises():
    _, tcfg = _cfgs()
    opt = ttrain.make_optimizer()
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        ttrain.make_train_step(tcfg, opt, mesh=object())
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(tcfg.vocab_size, n=1)[0].items()}

    def detached_attention(p, tokens):
        # what a kernel output with no grad_fn would do: q/k/v projections
        # drop out of the graph
        p = {n: (t.detach() if "self_attn" in n and "o_proj" not in n else t)
             for n, t in p.items()}
        return tllama.forward(p, tokens, tcfg)[0]

    step = ttrain.make_train_step(tcfg, opt, forward_fn=detached_attention)
    with pytest.raises(RuntimeError, match="q_proj"):
        step(params, opt.init(params), batch)
