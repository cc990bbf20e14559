"""The port's mesh arithmetic, shard slices, placed loads and per-device
budget against the JAX package, on the CPU, with no process group.

- ``parse_mesh_spec``, ``mesh_str`` and ``weight_shard_factor`` against
  ``modelx_tpu/parallel/mesh.py`` over ``tests/test_sharding_mesh.py``'s
  cases, errors included (the same messages).
- Every family's per-rank slice (``Sharding.index``) against the
  reference's ``sharding_for(...).addressable_devices_indices_map`` on the
  forced 8-device host at dp=2,tp=4 and ep=2,tp=2: equal slices, exactly.
- ``cache_sharding``'s indivisible cases against the reference's specs.
- The loader's per-rank byte ranges partition a tensor's bytes, and a
  rank's placed load equals the reference loader's shard on that device,
  bit for bit.
- The pool's per-device budget against ``tests/test_sharding_mesh.py:
  280-300``, and a kernel bundle built for tp=2 skipped as mesh skew by a
  server at tp=1.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modelx_tpu.dl import loader as jloader
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.dl import sharding as jsh
from modelx_tpu.models import llama as jl
from modelx_tpu.parallel import mesh as jmesh
from modelx_tpu_torch.dl import loader as tloader
from modelx_tpu_torch.dl import safetensors as tst
from modelx_tpu_torch.dl import sharding as tsh
from modelx_tpu_torch.parallel import mesh as tmesh

SPECS = ["dp=2,tp=4", "dp=1", "dp=2,tp=2", "dp=8", "dp=2,sp=2,tp=2", "fsdp=2,tp=2",
         "tp=-1", "dp=2,tp=-1", "dp=1,sp=2,tp=4", "ep=2,tp=2"]
BAD_SPECS = ["", "dp", "dp=x", "dp=0", "dp=-2", "dp=2,dp=2", "dp=-1,tp=-1", "dp=16",
             "dp=3,tp=-1"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_arithmetic_equals_the_reference(spec):
    jm = jmesh.make_mesh(spec)
    tm = tmesh.make_mesh(spec, devices=8)
    assert tmesh.mesh_str(tm) == jmesh.mesh_str(jm)
    assert tm.size == jm.size
    assert tmesh.weight_shard_factor(tm) == jmesh.weight_shard_factor(jm)
    assert str(tmesh.parse_mesh_spec(spec)) == str(jmesh.parse_mesh_spec(spec))
    assert tmesh.parse_mesh_spec(tmesh.mesh_str(tm)).axes == dict(jm.shape)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_mesh_errors_equal_the_reference(spec):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(spec)
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(spec, devices=8)
    assert str(terr.value) == str(jerr.value)


def test_a_smaller_mesh_takes_a_prefix_and_needs_no_group():
    tm = tmesh.make_mesh("tp=2", devices=8)
    assert (tm.size, tm.devices, tm.live, tm.coord) == (2, 8, False, None)
    one = tmesh.make_mesh("dp=1")  # no process group: this process's device
    assert (one.size, one.live, one.is_leader, one.group("tp")) == (1, False, True, None)
    assert tmesh.mesh_str(tmesh.single_device_mesh()) == "dp=1"


# representative tensors of each family, at shapes every mesh axis divides
FAMILY_TENSORS = {
    "llama": [("model.embed_tokens.weight", (64, 16)), ("lm_head.weight", (64, 16)),
              ("model.layers.0.self_attn.q_proj.weight", (32, 16)),
              ("model.layers.0.self_attn.k_proj.weight", (16, 16)),
              ("model.layers.0.self_attn.o_proj.weight", (16, 32)),
              ("model.layers.0.mlp.gate_proj.weight", (48, 16)),
              ("model.layers.0.mlp.down_proj.weight", (16, 48)),
              ("model.norm.weight", (16,)), ("rope.cache", (8, 8))],
    "qwen2": [("model.layers.0.self_attn.q_proj.bias", (32,)),
              ("model.layers.0.self_attn.v_proj.weight", (16, 16)),
              ("model.layers.0.mlp.up_proj.weight", (48, 16))],
    "gemma2": [("model.layers.0.self_attn.v_proj.weight", (16, 16)),
               ("model.layers.0.pre_feedforward_layernorm.weight", (16,))],
    "phi3": [("model.layers.0.self_attn.qkv_proj.weight", (48, 16)),
             ("model.layers.0.mlp.gate_up_proj.weight", (64, 16)),
             ("model.layers.0.mlp.down_proj.weight", (16, 32))],
    "gpt2": [("wte.weight", (64, 16)), ("wpe.weight", (32, 16)),
             ("h.0.attn.c_attn.weight", (16, 48)), ("h.0.attn.c_attn.bias", (48,)),
             ("h.0.attn.c_proj.weight", (16, 16)), ("h.0.mlp.c_fc.weight", (16, 64)),
             ("h.0.mlp.c_proj.weight", (64, 16))],
    "bert": [("embeddings.word_embeddings.weight", (64, 16)),
             ("encoder.layer.0.attention.self.query.weight", (16, 16)),
             ("encoder.layer.0.attention.self.key.bias", (16,)),
             ("encoder.layer.0.attention.output.dense.weight", (16, 16)),
             ("encoder.layer.0.intermediate.dense.weight", (64, 16)),
             ("encoder.layer.0.output.dense.weight", (16, 64))],
    "mixtral": [("model.layers.0.self_attn.q_proj.weight", (32, 16)),
                ("model.layers.0.block_sparse_moe.gate.weight", (4, 16)),
                ("model.layers.0.block_sparse_moe.experts.w1.weight", (4, 48, 16)),
                ("model.layers.0.block_sparse_moe.experts.w2.weight", (4, 16, 48))],
}


def _norm(idx, shape) -> tuple:
    return tuple(sl.indices(n)[:2] for sl, n in zip(idx, shape))


def _reference_map(sharding, shape) -> dict:
    return {d.id: _norm(idx, shape)
            for d, idx in sharding.addressable_devices_indices_map(shape).items()}


@pytest.mark.parametrize("spec", ["dp=2,tp=4", "ep=2,tp=2"])
@pytest.mark.parametrize("family", sorted(FAMILY_TENSORS))
def test_rank_slices_equal_the_reference_shards(family, spec):
    jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, devices=8)
    jrules, trules = jsh.rules_for_family(family), tsh.rules_for_family(family)
    assert tsh.encode_rules(trules) == jsh.encode_rules(jrules)
    for name, shape in FAMILY_TENSORS[family]:
        jspec = jsh.clean_spec(jsh.spec_for(name, jrules), jm)
        tspec = tsh.clean_spec(tsh.spec_for(name, trules), tm)
        assert tspec == tuple(jspec), (name, tspec, jspec)
        want = _reference_map(jsh.sharding_for(name, jrules, jm), shape)
        got = {r: _norm(idx, shape)
               for r, idx in tsh.sharding_for(name, trules, tm).indices_map(shape).items()}
        assert got == want, (family, name)


def test_multi_axis_entries_split_in_the_reference_order():
    # LLAMA_FSDP_RULES' ["tp", "fsdp"] entries: tp major, fsdp minor
    rules = jsh.LLAMA_FSDP_RULES
    for spec in ("fsdp=2,tp=2", "tp=2,fsdp=4", "dp=2,fsdp=2,tp=2"):
        jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, devices=8)
        for name, shape in (("model.embed_tokens.weight", (64, 16)),
                            ("model.layers.0.self_attn.q_proj.weight", (32, 16)),
                            ("model.layers.0.self_attn.o_proj.weight", (16, 32))):
            want = _reference_map(jsh.sharding_for(name, rules, jm), shape)
            got = {r: _norm(idx, shape) for r, idx in
                   tsh.sharding_for(name, rules, tm).indices_map(shape).items()}
            assert got == want, (spec, name)


CACHE_CASES = [("dp=2,tp=2", (4, 96, 2, 32), 0), ("dp=2,tp=2", (4, 96, 3, 32), 0),
               ("dp=2,tp=2", (3, 96, 2, 32), 0), ("dp=2,tp=2", (8, 16, 2, 32), -1),
               ("dp=1", (4, 96, 2, 32), 0), ("dp=4,tp=2", (2, 16, 6, 8), 0),
               ("tp=8", (1, 16, 4, 8), 0)]


@pytest.mark.parametrize("spec,shape,batch_dim", CACHE_CASES)
def test_cache_sharding_equals_the_reference(spec, shape, batch_dim):
    jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, devices=8)
    js = jsh.cache_sharding(jm, shape, batch_dim=batch_dim, head_dim=2)
    ts = tsh.cache_sharding(tm, shape, batch_dim=batch_dim, head_dim=2)
    assert ts.spec == tuple(js.spec)
    assert ts.is_fully_replicated(shape) == js.is_fully_replicated
    got = {r: _norm(i, shape) for r, i in ts.indices_map(shape).items()}
    assert got == _reference_map(js, shape)


# -- placed loads -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = jl.LlamaConfig.tiny(vocab_size=64)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("mesh-ckpt") / "model.safetensors")
    jst.write_safetensors(path, {k: np.asarray(v) for k, v in params.items()})
    return path


@pytest.mark.parametrize("spec", ["dp=2,tp=4", "tp=2"])
def test_rank_byte_ranges_partition_the_bytes(tiny_ckpt, spec):
    tm = tmesh.make_mesh(spec, devices=8)
    infos, _ = tst.read_header_from_file(tiny_ckpt)
    for name, info in infos.items():
        shard = tsh.sharding_for(name, tsh.LLAMA_RULES, tm)
        spans = set()
        for idx in shard.indices_map(info.shape).values():
            runs = tloader._byte_runs(info, idx)
            spans.add(tuple((src, n) for _, src, n in runs))
            assert sum(n for _, _, n in runs) == 4 * int(np.prod(
                [sl.stop - sl.start for sl in idx]))  # F32: the slice's bytes
        cut = [(src, n) for span in spans for src, n in span]
        cut.sort()
        # the distinct shards' ranges tile the tensor exactly once
        assert cut[0][0] == info.start and cut[-1][0] + cut[-1][1] == info.end, name
        assert all(a + n == b for (a, n), (b, _) in zip(cut, cut[1:])), name
        assert sum(n for _, n in cut) == info.nbytes, name


def test_dim1_slice_reads_one_range_per_row():
    info = tst.TensorInfo(name="o_proj.weight", dtype="F32", shape=(6, 8), start=64,
                          end=64 + 6 * 8 * 4)
    runs = tloader._byte_runs(info, (slice(0, 6), slice(4, 8)))
    assert [(src, n) for _, src, n in runs] == [(64 + r * 32 + 16, 16) for r in range(6)]
    assert [dst for dst, _, _ in runs] == [16 * r for r in range(6)]
    one = tloader._byte_runs(info, (slice(2, 4), slice(0, 8)))
    assert [(src, n) for _, src, n in one] == [(64 + 64, 64)]


@pytest.mark.parametrize("spec", ["dp=2,tp=4", "tp=2"])
def test_a_ranks_placed_load_equals_the_reference_shard(tiny_ckpt, spec):
    jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, devices=8)
    src = jloader.LocalFileSource(tiny_ckpt)
    try:
        jarrays, _ = jloader.load_safetensors(src, jm, jsh.LLAMA_RULES)
    finally:
        src.close()
    total = sum(i.nbytes for i in tst.read_header_from_file(tiny_ckpt)[0].values())
    for rank in (0, tm.size - 1):
        rcoord = {}
        idx = rank
        for name in reversed(tm.axis_names):
            rcoord[name] = idx % tm.shape[name]
            idx //= tm.shape[name]

        def index(name, shape, rcoord=rcoord):
            return tsh.sharding_for(name, tsh.LLAMA_RULES, tm).index(shape, rcoord)

        tsrc = tloader.LocalFileSource(tiny_ckpt)
        try:
            tarrays, stats = tloader.load_safetensors(tsrc, "cpu", index=index)
        finally:
            tsrc.close()
        for name, arr in jarrays.items():
            (want,) = [s.data for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(tarrays[name].numpy(), np.asarray(want), err_msg=name)
        # a rank of a tp-split load reads the split tensors' 1/tp (norms whole)
        tp = tm.shape["tp"]
        assert total // tp < stats.bytes_fetched < total // tp + total // 8
        assert stats.bytes_to_device == stats.bytes_fetched


# -- the pool's per-device budget, and bundles keyed by the mesh ---------------


class _StubSet:
    def __init__(self):
        self.servers = {}


class _StubServer:
    def __init__(self, load_bytes):
        self.stats = {"load_bytes": load_bytes}
        self.model_dir = ""


def _pools(spec):
    from modelx_tpu.dl.lifecycle import ModelPool as JPool
    from modelx_tpu_torch.dl.lifecycle import ModelPool as TPool

    jp = JPool(_StubSet(), mesh=jmesh.make_mesh(spec) if spec else None)
    tp = TPool(_StubSet(), mesh=tmesh.make_mesh(spec, devices=8) if spec else None)
    return jp, tp


@pytest.mark.parametrize("spec", ["dp=2,tp=4", "dp=8", None, "dp=2,sp=2,tp=2", "fsdp=2,tp=2"])
def test_per_device_budget_equals_the_reference(spec):
    jp, tp = _pools(spec)
    assert tp.weight_shard_factor == jp.weight_shard_factor
    for n in (0, 1000, 1001, 12345):
        assert tp._per_device(n) == jp._per_device(n)


def test_mark_ready_tightens_to_per_device_bytes():
    from modelx_tpu_torch.dl.lifecycle import ModelPool

    sset = _StubSet()
    sset.servers["m"] = _StubServer(load_bytes=1000)
    pool = ModelPool(sset, mesh=tmesh.make_mesh("dp=2,tp=4", devices=8))
    pool.mark_ready("m")
    assert pool.entries["m"].hbm_reserved_bytes == 250


def test_pool_snapshot_mesh_keys():
    jp, tp = _pools("dp=2,tp=2")
    snap, jsnap = tp.pool_snapshot(), jp.pool_snapshot()
    for key in ("mesh", "mesh_devices", "weight_shard_factor"):
        assert snap[key] == jsnap[key]
    # without a mesh the reference omits the keys; its pods always have one
    # (dp over every device), which the port's one-card pod spells dp=1
    _, bare = _pools(None)
    assert {k: bare.pool_snapshot()[k] for k in ("mesh", "mesh_devices",
                                                 "weight_shard_factor")} == {
        "mesh": "dp=1", "mesh_devices": 1, "weight_shard_factor": 1}


def test_a_tp2_bundle_is_mesh_skew_at_tp1(tmp_path, tiny_ckpt):
    from modelx_tpu_torch.dl import program_store as ps
    from modelx_tpu_torch.dl.serve import ModelServer
    from modelx_tpu_torch.kernels import build

    src = tmp_path / "src"
    src.mkdir()
    (src / build.library_name()).write_bytes(b"\x7fELF a stand-in kernel library")
    model = tmp_path / "model"
    model.mkdir()
    os.link(tiny_ckpt, model / "model.safetensors")
    (model / ps.bundle_name(mesh="tp=2")).write_bytes(ps.build_bundle(str(src), mesh="tp=2"))
    server = ModelServer(str(model), dtype="float32", device="cpu",
                         mesh=tmesh.make_mesh("tp=1"))
    stats = server.load()
    assert stats["mesh"] == "tp=1" and stats["weight_shard_factor"] == 1
    assert stats["programs"]["skipped"] == 1 and stats["programs"]["installed"] == 0
    # and a one-rank mesh serves as one card
    tok = np.random.RandomState(0).randint(0, 64, (1, 8))
    plain = ModelServer(str(model), dtype="float32", device="cpu")
    plain.load()
    np.testing.assert_array_equal(server.forward_argmax(tok), plain.forward_argmax(tok))
    np.testing.assert_array_equal(server.generate(tok, max_new_tokens=5),
                                  plain.generate(tok, max_new_tokens=5))
    assert torch.equal(server.params["lm_head.weight"], plain.params["lm_head.weight"])


# -- the trainer's placement half -------------------------------------------------


@pytest.mark.parametrize("spec", ["dp=2,tp=4", "fsdp=2,tp=2", "dp=2,sp=2,tp=2"])
def test_train_placement_equals_the_reference_shards(spec, tiny_ckpt):
    from modelx_tpu.models import train as jtrain
    from modelx_tpu_torch.models import train as ttrain

    jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, devices=8)
    rules = jsh.LLAMA_FSDP_RULES if "fsdp" in spec else jsh.LLAMA_RULES
    params = {k: v.numpy() for k, v in tst.read_tensors(tiny_ckpt).items()}
    jparams = jtrain.shard_params({k: jnp.asarray(v) for k, v in params.items()}, rules, jm)
    batch = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    jbatch = jax.device_put(jnp.asarray(batch), jtrain.batch_sharding(jm))
    for rank in range(tm.size):
        at = tmesh.Mesh(tm.shape, 8, rank=rank)  # the arithmetic at rank r
        got = ttrain.shard_params({k: torch.from_numpy(v) for k, v in params.items()},
                                  tsh.decode_rules(jsh.encode_rules(rules)), at)
        for name, arr in jparams.items():
            (want,) = [s.data for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want), err_msg=name)
        (want,) = [s.data for s in jbatch.addressable_shards if s.device.id == rank]
        np.testing.assert_array_equal(ttrain.batch_rows(torch.from_numpy(batch), at).numpy(),
                                      np.asarray(want))
