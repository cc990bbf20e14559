"""The port's checkpointer (``modelx_tpu_torch/dl/checkpoint.py``) against
``modelx_tpu/dl/checkpoint.py`` on the CPU.

A checkpoint crosses between the packages both ways: for the same state
(tiny llama, fp32, after one AdamW step) the port writes byte-identical
``state-*.safetensors`` shards and ``checkpoint.json`` (the 0-d count as
shape [1], as the reference stores it), each package restores the other's
exactly, and a run that JAX starts and the port resumes equals JAX's own
(the tolerance of tests/test_torch_train.py: params within 2e-6 but for at
most 1 element in 10,000, those within lr; moments within 1e-4 of each
tensor's largest entry). Pruning and the second push are the reference's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import checkpoint as jck
from modelx_tpu.models import llama as jllama
from modelx_tpu.models import train as jtrain
from modelx_tpu_torch.dl import checkpoint as tck
from modelx_tpu_torch.dl import safetensors as tst
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import llama as tllama
from modelx_tpu_torch.models import train as ttrain

LR = 3e-4


def _batch(vocab, seed):
    w = np.random.RandomState(seed).randint(0, vocab, (2, 17)).astype(np.int32)
    return {"tokens": w[:, :-1], "targets": w[:, 1:]}


def _port_state(jstate) -> ttrain.AdamWState:
    adam = jstate[0]
    return ttrain.AdamWState(
        count=torch.tensor(int(adam.count), dtype=torch.int32),
        mu={n: torch.from_numpy(np.asarray(t).copy()) for n, t in adam.mu.items()},
        nu={n: torch.from_numpy(np.asarray(t).copy()) for n, t in adam.nu.items()})


@pytest.fixture(scope="module")
def jax_run():
    """JAX's tiny fp32 llama and its AdamW state after each of 3 steps."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=64), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jtrain.make_optimizer(lr=LR)
    state = opt.init(params)
    step = jax.jit(jtrain.make_train_step(jcfg, opt))
    states = []
    for i in range(3):
        params, state, _ = step(params, state, {k: jnp.asarray(v)
                                                for k, v in _batch(64, i).items()})
        states.append(({k: np.asarray(v) for k, v in params.items()}, state))
    return jcfg, tcfg, opt, states


def _files(d):
    return sorted(os.listdir(d))


def test_shards_and_checkpoint_json_are_byte_identical(jax_run, tmp_path):
    _, _, _, states = jax_run
    params, state = states[0]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jck.Checkpointer(str(jdir)).save(params, state, step=5)
    tck.Checkpointer(str(tdir)).save(from_jax_params(params, device="cpu"), _port_state(state),
                                     step=5)
    assert _files(jdir) == _files(tdir) == ["checkpoint.json", "state-base.safetensors",
                                            "state-layer-00000.safetensors",
                                            "state-layer-00001.safetensors"]
    for name in _files(jdir):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    infos, _ = tst.read_header_from_file(str(tdir / "state-base.safetensors"))
    assert infos["__opt__0|count"].shape == (1,)
    assert "__opt__0|mu|model.embed_tokens.weight" in infos


def test_each_package_restores_the_others_checkpoint(jax_run, tmp_path):
    _, _, _, states = jax_run
    params, state = states[1]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jck.Checkpointer(str(jdir)).save(params, state, step=2)
    tparams = from_jax_params(params, device="cpu")
    tck.Checkpointer(str(tdir)).save(tparams, _port_state(state), step=2)

    topt = ttrain.make_optimizer(lr=LR)
    got, got_state, step = tck.Checkpointer(str(jdir)).restore(tparams, topt.init(tparams),
                                                               device="cpu")
    assert step == 2 and int(got_state.count) == 2 and got_state.count.shape == ()
    for name, t in tparams.items():
        assert torch.equal(got[name], t), name
        assert torch.equal(got_state.mu[name], torch.from_numpy(np.array(state[0].mu[name])))
        assert torch.equal(got_state.nu[name], torch.from_numpy(np.array(state[0].nu[name])))

    jgot, jgot_state, jstep = jck.Checkpointer(str(tdir)).restore(params, state)
    assert jstep == 2
    for name in params:
        np.testing.assert_array_equal(jgot[name], params[name])
    for a, b in zip(jax.tree.leaves(jgot_state), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_trains_two_the_port_resumes_one_equals_jax_three(jax_run, tmp_path):
    _, tcfg, _, states = jax_run
    params2, state2 = states[1]
    d = tmp_path / "run"
    jck.Checkpointer(str(d)).save(params2, state2, step=2)

    topt = ttrain.make_optimizer(lr=LR)
    template = {n: torch.empty(s, device="meta") for n, s in tllama.param_shapes(tcfg).items()}
    params, opt_state, step = tck.Checkpointer(str(d)).restore(template, topt.init(template),
                                                               device="cpu")
    assert step == 2
    train_step = ttrain.make_train_step(tcfg, topt)
    params, opt_state, _ = train_step(params, opt_state, {
        k: torch.from_numpy(v) for k, v in _batch(64, 2).items()})

    params3, state3 = states[2]
    assert int(opt_state.count) == 3
    off = total = 0
    for name, p in params.items():
        gap = np.abs(p.detach().numpy() - params3[name])
        assert gap.max() <= LR, name
        off += int((gap > 2e-6).sum())
        total += gap.size
        for mine, theirs in ((opt_state.mu[name], state3[0].mu[name]),
                             (opt_state.nu[name], state3[0].nu[name])):
            theirs = np.asarray(theirs)
            assert np.abs(mine.numpy() - theirs).max() <= 1e-4 * np.abs(theirs).max(), name
    assert off <= total // 10_000, (off, total)


def test_stale_shards_pruned_and_foreign_safetensors_left_alone(jax_run, tmp_path):
    _, _, _, states = jax_run
    params = from_jax_params(states[0][0], device="cpu")
    d = tmp_path / "ck"
    d.mkdir()
    foreign = d / "model.safetensors"
    tst.write_safetensors(str(foreign), {"w": torch.ones(3)})
    payload = foreign.read_bytes()
    ckpt = tck.Checkpointer(str(d))
    ckpt.save(dict(params, **{"model.layers.99.w": torch.ones(4)}), None, step=1)
    assert (d / "state-layer-00099.safetensors").exists()
    ckpt.save(params, None, step=2)
    assert not (d / "state-layer-00099.safetensors").exists()
    assert foreign.read_bytes() == payload
    restored, opt, step = ckpt.restore(params)
    assert step == 2 and opt is None and "model.layers.99.w" not in restored
    with pytest.raises(KeyError, match="missing params"):
        ckpt.restore(dict(params, **{"model.not_there.weight": torch.ones(2)}))


def test_group_key_and_flatten_names_are_the_references():
    for name in ("model.layers.3.mlp.gate_proj.weight", "model.embed_tokens.weight",
                 "__opt__0|mu|model.layers.11.self_attn.q_proj.weight", "__opt__0|count"):
        assert tck.group_key(name) == jck.group_key(name)
    state = ttrain.AdamWState(count=torch.tensor(4, dtype=torch.int32),
                              mu={"a": torch.ones(2)}, nu={"a": torch.zeros(2)})
    flat = tck.flatten_state(state)
    assert sorted(flat) == ["__opt__0|count", "__opt__0|mu|a", "__opt__0|nu|a"]
    back = tck.restore_state(state, flat)
    assert back.count.shape == () and int(back.count) == 4
    flat["__opt__0|mu|a"] = torch.ones(3)
    with pytest.raises(ValueError, match="shape"):
        tck.restore_state(state, flat)


def test_a_second_push_uploads_only_changed_shards(jax_run, tmp_path):
    from modelx_tpu_torch.registry.fs import MemoryFSProvider
    from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
    from modelx_tpu_torch.registry.store_fs import FSRegistryStore

    _, _, _, states = jax_run
    params = from_jax_params(states[0][0], device="cpu")
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}"),
                         store=FSRegistryStore(MemoryFSProvider()))
    base = srv.serve_background()
    try:
        def puts():
            return srv.registry.metrics.counters.get("blob_put_total", 0.0)

        ckpt = tck.Checkpointer(str(tmp_path / "ck"))
        ckpt.save(params, None, step=1)
        ckpt.push(f"{base}/library/train@v1")
        first = puts()
        assert first == 4  # three shards and checkpoint.json
        name = "model.layers.0.self_attn.q_proj.weight"
        ckpt.save(dict(params, **{name: params[name] + 1}), None, step=2)
        ckpt.push(f"{base}/library/train@v2")
        # the layer-0 shard and checkpoint.json changed; the rest deduped
        assert puts() - first == 2
    finally:
        srv.shutdown()
