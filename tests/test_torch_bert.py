"""Port bert (modelx_tpu_torch.models.bert) and its serving against the JAX
package, on the CPU.

A tiny fp32 bert (the JAX tiny preset: 2 layers, hidden 64, 4 heads, 64
positions; its zero biases and unit layer norms moved off their init
values) gives the JAX forward's sequence and pooled outputs within atol
1e-5, with and without token-type ids. ``infer_bert_config`` reads the
same config as the JAX package's from written checkpoints, the hidden <=
128 head rule included. A JAX pod and a port pod serving the checkpoint
answer ``/v1/forward`` with the same bytes and refuse every generate
(tokens, text, streamed; completions, chat) with the same status and
body; the encoder is never batched and gets no continuous engine. Past the
position table the JAX sidecar answers 200 (its gather past the table
fills NaN) where the port answers gpt2's 400 before any device work: a
known gap of the reference, not ported.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_family_util as fu
from modelx_tpu.dl import families as jfam
from modelx_tpu.dl import safetensors as jst
from modelx_tpu.models import bert as jb
from modelx_tpu_torch.dl import families as tfam
from modelx_tpu_torch.dl import safetensors as tst
from modelx_tpu_torch.dl.serve import ModelServer, ServerSet
from modelx_tpu_torch.dl.weights import from_jax_params
from modelx_tpu_torch.models import bert as tb

FP32_ATOL = 1e-5


def _jparams(jcfg, seed=0):
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    return {k: (np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(np.float32)
                if k.endswith(".bias") or "LayerNorm" in k else np.asarray(v))
            for k, v in jparams.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jb.BertConfig.tiny()
    jparams = _jparams(jcfg)
    fields = [f for f in tb.BertConfig.__dataclass_fields__ if f != "dtype"]
    tcfg = tb.BertConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)
    return jcfg, jparams, tcfg, from_jax_params(jparams, device="cpu")


@pytest.mark.parametrize("with_types", [False, True], ids=["no-token-types", "token-types"])
def test_forward_matches_jax_fp32(tiny, with_types):
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, jcfg.vocab_size, (3, 40))
    types = rng.randint(0, jcfg.type_vocab_size, (3, 40)) if with_types else None
    jseq, jpool = jb.forward({k: jnp.asarray(v) for k, v in jparams.items()},
                             jnp.asarray(tokens), jcfg,
                             None if types is None else jnp.asarray(types))
    tseq, tpool = tb.forward(tparams, torch.as_tensor(tokens), tcfg,
                             None if types is None else torch.as_tensor(types))
    assert tseq.shape == (3, 40, 64) and tpool.shape == (3, 64)
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), atol=FP32_ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=FP32_ATOL)


def test_forward_refuses_past_the_position_table(tiny):
    _, _, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="prompt length 65 exceeds the model's 64-position"):
        tb.forward(tparams, torch.zeros((1, 65), dtype=torch.int64), tcfg)


def test_param_shapes_and_init_match_jax():
    for jcfg in (jb.BertConfig.tiny(), jb.BertConfig.bert_base()):
        fields = [f for f in tb.BertConfig.__dataclass_fields__ if f != "dtype"]
        tcfg = tb.BertConfig(**{f: getattr(jcfg, f) for f in fields})
        assert tb.param_shapes(tcfg) == jb.param_shapes(jcfg)
    cfg = tb.BertConfig.tiny()
    params = tb.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in params.items()} == tb.param_shapes(cfg)
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    assert bool((params["bert.embeddings.LayerNorm.weight"] == 1).all())
    assert float(params["bert.pooler.dense.weight"].float().std()) == pytest.approx(0.02, rel=0.2)


@pytest.mark.parametrize("hidden,inter,heads", [(64, 128, 4), (128, 256, 4), (192, 384, 3),
                                                 (256, 512, 4)],
                         ids=["h64", "h128", "h192", "h256"])
def test_infer_bert_config_matches_jax_on_written_checkpoints(tmp_path, hidden, inter, heads):
    """Both packages' readers on the same written file; hidden <= 128 reads
    4 heads, above that hidden // 64."""
    jcfg = dataclasses.replace(jb.BertConfig.tiny(), hidden_size=hidden,
                               intermediate_size=inter, num_layers=3, vocab_size=100,
                               max_position_embeddings=48, type_vocab_size=3)
    path = str(tmp_path / "model.safetensors")
    jst.write_safetensors(path, {k: np.asarray(v) for k, v in _jparams(jcfg).items()})
    jinfos, _ = jst.read_header_from_file(path)
    tinfos, _ = tst.read_header_from_file(path)
    jc = jfam.infer_bert_config({n: jax.ShapeDtypeStruct(i.shape, jnp.float32)
                                 for n, i in jinfos.items()})
    tc = tfam.infer_bert_config(tfam.abstract_params(tinfos))
    fields = [f for f in tb.BertConfig.__dataclass_fields__ if f != "dtype"]
    assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
    assert tc.num_heads == heads and tc.num_layers == 3 and tc.dtype == torch.float32
    assert tfam.detect(list(tinfos)).name == jfam.detect(list(jinfos)).name == "bert"


# -- serving ------------------------------------------------------------------


def _wordpiece_tokenizer() -> str:
    """A BERT tokenizer.json trained here, ids inside the tiny vocab."""
    import tokenizers
    from tokenizers import decoders, models, normalizers, pre_tokenizers, processors, trainers

    tok = tokenizers.Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(["the encoder reads the whole sentence at once"] * 20,
                            trainers.WordPieceTrainer(vocab_size=120, show_progress=False,
                                                      special_tokens=["[PAD]", "[UNK]", "[CLS]",
                                                                      "[SEP]", "[MASK]"]))
    tok.post_processor = processors.BertProcessing(("[SEP]", tok.token_to_id("[SEP]")),
                                                   ("[CLS]", tok.token_to_id("[CLS]")))
    tok.decoder = decoders.WordPiece()
    return tok.to_str()


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    d = fu.write_checkpoint(str(tmp_path_factory.mktemp("tiny-bert")),
                            _jparams(jb.BertConfig.tiny()))
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        f.write(_wordpiece_tokenizer())
    pods = fu.Pods(d, "bert")
    yield pods
    pods.close()


_TOKS = np.random.RandomState(3).randint(0, 256, (2, 20)).tolist()

REFUSED = [
    ("/v1/generate", {"tokens": _TOKS, "max_new_tokens": 4}),
    ("/v1/bert/generate", {"tokens": _TOKS[:1], "max_new_tokens": 4, "temperature": 0.8,
                           "seed": 1}),
    ("/v1/generate", {"tokens": _TOKS[:1], "max_new_tokens": 4, "stream": True}),
    ("/v1/generate", {"text": "the encoder reads", "max_new_tokens": 4}),
    ("/v1/completions", {"prompt": "the encoder", "max_tokens": 4}),
    ("/v1/completions", {"prompt": "the encoder", "max_tokens": 4, "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 4}),
]


def test_forward_bytes_identical_to_jax(pods):
    for body in ({"tokens": _TOKS}, {"tokens": [_TOKS[0][:7]]}):
        (js, jraw), (ts, traw) = pods.both("/v1/forward", body)
        assert ts == js == 200 and traw == jraw
        assert np.asarray(json.loads(traw)["logits_argmax"]).max() < 64  # argmax over E


@pytest.mark.parametrize("path,body", REFUSED, ids=[
    "generate", "sampled", "stream", "text", "completions", "completions-sse", "chat"])
def test_generate_refused_as_jax(pods, path, body):
    (js, jraw), (ts, traw) = pods.both(path, body)
    assert (ts, traw) == (js, jraw)
    assert ts == 400 and b"not" in traw  # "not generative" / "does not support streaming"


def test_past_the_position_table_both_answers(pods):
    """The JAX sidecar serves a 65-token forward on its 64-position table
    (200; the gather past it fills NaN); the port answers gpt2's 400
    before any device work. A known gap of the reference."""
    body = {"tokens": [list(range(65))]}
    (js, jraw), (ts, traw) = pods.both("/v1/forward", body)
    assert js == 200 and len(json.loads(jraw)["logits_argmax"][0]) == 65
    assert ts == 400 and json.loads(traw) == {
        "error": "prompt length 65 exceeds the model's 64-position context"}
    (js, jraw), (ts, traw) = pods.both("/v1/forward", {"tokens": [list(range(64))]})
    assert ts == js == 200 and traw == jraw


def test_generate_raises_not_generative(pods):
    with pytest.raises(ValueError, match="family bert is not generative"):
        pods.server.generate(np.asarray([[1, 2]], np.int32))


def test_encoder_never_batched_and_gets_no_engine(pods):
    """Right padding changes a bidirectional encoder's outputs: no window
    batcher even with dynamic_batch, and no continuous engine (no decode
    entry points) with continuous_batch."""
    server = ModelServer(pods.server.model_dir, dtype="float32", device="cpu", name="b")
    server.load()
    sset = ServerSet({"b": server}, dynamic_batch=True, continuous_batch=True)
    try:
        assert sset.batcher_for(server) is None and sset.continuous_for(server) is None
        assert sset.engine_for(server, 1, 0.0) is server
        assert sset.batchers == {} and sset.cbatchers == {}
    finally:
        sset.close()
