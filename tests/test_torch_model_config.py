"""The port's modelx.yaml reader (modelx_tpu_torch.utils.miniyaml, under
modelx_tpu_torch.client.model_config) against ``yaml.safe_load``, on the
CPU: the same value, exactly (NaN compared as NaN), for the JAX package's
``ModelConfig.to_yaml`` output over hypothesis-drawn configs and for every
hand-written modelx.yaml of the repo's docs and tests; ``ValueError``
outside the subset."""

import math

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from modelx_tpu.client.model_config import ModelConfig as JaxModelConfig
from modelx_tpu.client.model_config import ServingConfig as JaxServingConfig
from modelx_tpu_torch.client.model_config import ModelConfig
from modelx_tpu_torch.utils import miniyaml


def _same(a, b) -> bool:
    """Equal values of equal types (bool is not int; NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# the modelx.yaml files the repo writes by hand (docs/annotations.md,
# docs/sharding.md serving.mesh; tests/test_client.py, test_outage.py,
# test_sharding_mesh.py, test_ops.py, ...), and the forms a hand-written
# file takes beside them
HAND_WRITTEN = [
    "description: test\nframework: jax\n",
    "files: ['*.safetensors']\n",
    "serving:\n  mesh: dp=2,tp=2\n",
    "framework: jax\n",
    "description: kv-test\nframework: jax\n",
    "description: t\n",
    "serving:\n  mesh: \"dp=1,sp=2,tp=4\"\n  model_family: llama\n",
    "modelFiles:\n  - model.safetensors\n  - tokenizer/vocab.txt\nserving:\n"
    "  dtype: float32\n",
    "# a comment\n---\ndescription: x  # trailing\ntags: [a, 'b c', \"d\"]\n...\n",
    "resources: {cpu: 1, memory: 2Gi, tpu: 8}\nmaintainers:\n- a <a@b.c>\n- b\n",
    "config:\n  layers: 0x20\n  rate: 1.5e-3\n  off: off\n  empty:\n  list: []\n"
    "  map: {}\n  nested:\n  - - 1\n    - 2\n  - {a: 1, b: [x, y]}\n",
    "description: a long plain description that\n  continues on the next line\n\n"
    "  and a paragraph\ntask: 'it''s quoted'\nframework: \"esc\\t\\u00e9 \\\n  joined\"\n",
    "",
    "# only a comment\n",
    "annotations:\n  modelx.shard.mesh: dp=1\n  \"with: colon\": v\n",
    "ints: [0, -7, +3, 010, 0b101, 1_000, 1:30, 09]\nfloats: [1.0, -.5, .inf, -.Inf, "
    ".NaN, 1.5e+3, 6.0:30.5]\nbools: [yes, No, ON, true, FALSE, y, n]\nnulls: [~, null, "
    "Null]\n",
    "serving:\n  mesh: dp=1\n  extra_key: [1, {k: v}]\n",
]

OUTSIDE = [
    "a: &x 1\nb: *x\n",
    "a: !!str 1\n",
    "a: |\n  text\n",
    "a: >\n  text\n",
    "%YAML 1.1\n---\na: 1\n",
    "? [complex]\n: key\n",
    "a: 2024-01-01\n",
    "<<: {a: 1}\n",
    "a: 1\n---\nb: 2\n",
    "a:\tb\n",
    "a: [x: 1]\n",
    "a: 'unterminated\n",
    "a: 1\n b: 2\n",
    "a: \x01\n",
]


@pytest.mark.parametrize("text", HAND_WRITTEN, ids=range(len(HAND_WRITTEN)))
def test_hand_written_configs_equal_safe_load(text):
    assert _same(miniyaml.loads(text), yaml.safe_load(text)), text
    if isinstance(yaml.safe_load(text) or {}, dict):
        want = JaxModelConfig.from_yaml(text)
        got = ModelConfig.from_yaml(text)
        assert str(got) == str(want)


@pytest.mark.parametrize("text", OUTSIDE, ids=range(len(OUTSIDE)))
def test_outside_the_subset_raises_value_error(text):
    with pytest.raises(ValueError):
        miniyaml.loads(text)
    with pytest.raises(ValueError):
        ModelConfig.from_yaml(text)


_text = st.text(max_size=120)
_key = st.text(min_size=1, max_size=20)
_leaf = st.one_of(st.none(), st.booleans(), st.integers(), st.floats(), _text)
_values = st.recursive(_leaf, lambda kids: st.one_of(
    st.lists(kids, max_size=3), st.dictionaries(_key, kids, max_size=3)), max_leaves=8)
_configs = st.builds(
    JaxModelConfig,
    description=_text, framework=_text, task=_text,
    tags=st.lists(_text, max_size=3), resources=st.dictionaries(_key, _values, max_size=3),
    maintainers=st.lists(_text, max_size=3),
    annotations=st.dictionaries(_key, _text, max_size=3),
    model_files=st.lists(_text, max_size=3), config=_values,
    serving=st.builds(JaxServingConfig, model_family=_text, mesh=_text, dtype=_text,
                      topology=_text, extra=st.dictionaries(_key, _values, max_size=2)),
)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(cfg=_configs)
def test_jax_to_yaml_reads_as_safe_load(cfg):
    text = cfg.to_yaml()
    assert _same(miniyaml.loads(text), yaml.safe_load(text)), text
