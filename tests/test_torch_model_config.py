"""The port's modelx.yaml reader (modelx_tpu_torch.utils.miniyaml, under
modelx_tpu_torch.client.model_config) against ``yaml.safe_load``, on the
CPU: the same value, exactly (NaN compared as NaN), for the JAX package's
``ModelConfig.to_yaml`` output over hypothesis-drawn configs and for every
hand-written modelx.yaml of the repo's docs and tests, for block scalars
(literal and folded, every chomping and indentation indicator, as mapping
values and sequence items; hypothesis-drawn multi-line strings);
``ValueError`` outside the subset."""

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
    "a: |0\n  text\n",
    "a: |x\n  text\n",
    "a: [|, x]\n",
    "a: |\n    text\n  b: 1\n",
]

# block scalars (ROADMAP C.4): the cases that left OUTSIDE, the ROADMAP's
# example, and each indicator in a mapping and in a sequence
BLOCK_SCALARS = [
    "a: |\n  text\n",
    "a: >\n  text\n",
    "description: |\n  two lines\nmodelFiles:\n- model.safetensors\n",
    "description: |\n  two lines\n  of text\nmodelFiles:\n- model.safetensors\n",
    "a: |-\n  x\n  y\n\n\nb: 1\n",
    "a: >+\n  x\n  y\n\n  z\n\n\n",
    "a: >-\n  folded\n  lines\n",
    "a: |+\n  kept\n\nb: 2\n",
    "- |\n  a\n   b\n- >2\n   c\n  d\n",
    "k:\n- |\n  x\n- >-\n  y\n  z\n- plain\n",
    "k:\n  - |2\n      deeper\n     less\n  - 1\n",
    "a:\n  b: >\n    fold\n    me\n\n    para\n      more\n    end\n  c: 2\n",
    "a: |\n", "a: |+\n\n\n", "a: >\nb: 1\n", "a: |2-\n    x\n  y\n",
    "a: | # comment\n  x\n# top-level comment\nb: 2\n",
    "a: |\n  x\n  # not a comment\n", "a: |\n\n  \n  x\n", "a: >\n x\n\n\n y\n",
    "a: >\n  one\n   indented\n  two\n", "a: |\n  tab\there\n", "|\n  top level\n",
    "a: >1\n  lead\n b\n", "a: |-2\n   x\n", "a: >\n  trailing   \n  spaces\n",
]


@pytest.mark.parametrize("text", BLOCK_SCALARS, ids=range(len(BLOCK_SCALARS)))
def test_block_scalars_equal_safe_load(text):
    assert _same(miniyaml.loads(text), yaml.safe_load(text)), text
    if isinstance(yaml.safe_load(text), dict):
        assert str(ModelConfig.from_yaml(text)) == str(JaxModelConfig.from_yaml(text))


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


_line = st.text(alphabet=" ab#:-|>\t'\"", max_size=12)


@st.composite
def _block_scalar_docs(draw):
    """A modelx.yaml holding one block scalar: its style, chomping and
    indentation indicators, its place (a mapping value, a nested mapping
    value or a sequence item) and its lines drawn; every line blank or
    indented at least to the scalar's indentation, the rest after it."""
    style = draw(st.sampled_from("|>"))
    chomp = draw(st.sampled_from(["", "-", "+"]))
    explicit = draw(st.booleans())
    place = draw(st.sampled_from(["map", "nested", "seq"]))
    parent = {"map": 0, "nested": 2, "seq": 0}[place]
    indent = parent + draw(st.integers(1, 3))
    lines = draw(st.lists(st.tuples(st.integers(0, 2), _line), min_size=1, max_size=6))
    body = []
    for extra, text in lines:
        body.append("" if not text.strip(" ") else " " * (indent + extra) + text)
    if not explicit:
        # without the indicator the first content line sets the indentation
        first = next((i for i, b in enumerate(body) if b), None)
        if first is None:
            body.append(" " * indent + "x")
            first = len(body) - 1
        body[first] = " " * indent + body[first].lstrip(" ")
        if body[first].strip(" \t") == "" or body[first].lstrip(" ")[:1] == "\t":
            body[first] = " " * indent + "x"
    header = style + (str(indent - parent) if explicit else "") + chomp
    blank_tail = "\n" * draw(st.integers(0, 2))
    head = {"map": "a: ", "nested": "top:\n  a: ", "seq": "- "}[place]
    after = {"map": "b: 1\n", "nested": "  b: 1\nc: 2\n", "seq": "- 1\n"}[place]
    return head + header + "\n" + "\n".join(body) + "\n" + blank_tail + after


@settings(max_examples=300, deadline=None, derandomize=True)
@given(text=_block_scalar_docs())
def test_block_scalar_multiline_strings_read_as_safe_load(text):
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            miniyaml.loads(text)
        return
    assert _same(miniyaml.loads(text), want), text


@settings(max_examples=200, deadline=None, derandomize=True)
@given(lines=st.lists(st.text(alphabet=st.characters(codec="utf-8",
                                                     exclude_categories=("Cs",)),
                              max_size=20), min_size=2, max_size=5))
def test_safe_dump_block_styles_read_as_safe_load(lines):
    value = "\n".join(lines)
    for style in "|>":
        text = yaml.safe_dump({"description": value}, default_style=style, allow_unicode=True)
        want = yaml.safe_load(text)
        try:
            got = miniyaml.loads(text)
        except ValueError:
            # a character the reader refuses outright (a non-printable)
            assert miniyaml._NON_PRINTABLE.search(text) or any(
                c in text for c in "\x85\u2028\u2029"), text
            continue
        assert _same(got, want), text
