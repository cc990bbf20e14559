"""``modelx-train-torch`` (``modelx_tpu_torch/models/train_main.py``) against
``modelx-train`` (``modelx_tpu/models/train_main.py``, through click's
CliRunner) on the CPU: the same ``--model-dir`` (a tiny fp32 llama
written by the test) and ``.npy`` token stream give the same JSON keys and
a ``final_loss`` within 2e-5 relative (fp32, three AdamW steps; the train
step's own parity is tests/test_torch_train.py), and the same error texts.
The port refuses meshes beyond one device and defaults to the card."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from modelx_tpu.dl import safetensors as jst
from modelx_tpu.models import llama as jllama
from modelx_tpu.models.train_main import main as jax_train_main
from modelx_tpu_torch.models import train_main

VOCAB = 128


@pytest.fixture(scope="module")
def model_and_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=VOCAB), dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    model = root / "model"
    model.mkdir()
    jst.write_safetensors(str(model / "model.safetensors"),
                          {k: np.asarray(v) for k, v in params.items()})
    data = root / "tokens.npy"
    np.save(data, np.random.RandomState(0).randint(1, VOCAB, 2 * 17 * 4).astype(np.int32))
    return str(model), str(data)


def _jax(*args):
    res = CliRunner().invoke(jax_train_main, list(args))
    return res.exit_code, res.output


def _port(capsys, *args):
    rc = train_main.main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _error_line(text: str) -> str:
    return next(line for line in text.splitlines() if line.startswith("Error: "))


def test_same_summary_as_modelx_train(model_and_data, capsys):
    model, data = model_and_data
    common = ["--model-dir", model, "--data", data, "--steps", "3", "--batch", "2",
              "--seq", "16", "--log-every", "1"]
    rc, out = _jax(*common, "--mesh", "dp=1")
    assert rc == 0, out
    want = json.loads(out.strip().splitlines()[-1])
    rc, out, err = _port(capsys, *common, "--device", "cpu")
    assert rc == 0, err
    got = json.loads(out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) == ["final_loss", "mesh", "steps", "tokens_per_s"]
    assert got["steps"] == want["steps"] == 3 and got["mesh"] == want["mesh"] == "{'dp': 1}"
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=2e-5)


@pytest.mark.parametrize("what", ["too_little_data", "token_out_of_vocab",
                                  "push_without_checkpoint_dir"])
def test_same_error_texts(model_and_data, tmp_path, capsys, what):
    model, _ = model_and_data
    if what == "too_little_data":
        data = tmp_path / "tiny.npy"
        np.save(data, np.ones(10, np.int32))
        args = ["--model-dir", model, "--steps", "1", "--batch", "8", "--seq", "16",
                "--data", str(data)]
    elif what == "token_out_of_vocab":
        data = tmp_path / "big.npy"
        np.save(data, np.full(40, VOCAB + 72, np.int32))
        args = ["--model-dir", model, "--steps", "1", "--batch", "2", "--seq", "16",
                "--data", str(data)]
    else:
        args = ["--steps", "1", "--push", "http://127.0.0.1:9/library/m@v1"]
    rc, out = _jax(*args, "--mesh", "dp=1")
    assert rc != 0
    prc, _, err = _port(capsys, *args, "--device", "cpu")
    assert prc == 1
    assert _error_line(err) == _error_line(out)


def test_resume_continues_the_step_counter(model_and_data, tmp_path, capsys):
    model, data = model_and_data
    ck = str(tmp_path / "ck")
    common = ["--model-dir", model, "--data", data, "--batch", "2", "--seq", "16",
              "--checkpoint-dir", ck, "--device", "cpu", "--log-every", "1"]
    rc, out, err = _port(capsys, *common, "--steps", "2")
    assert rc == 0, err
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 2
    rc, out, err = _port(capsys, *common, "--steps", "1")
    assert rc == 0, err
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 3
    with open(f"{ck}/checkpoint.json") as f:
        assert json.load(f)["step"] == 3


@pytest.mark.parametrize("args", [["--mesh", "dp=2"], ["--mesh", "dp=1,tp=2"], ["--fsdp"]],
                         ids=["dp2", "tp", "fsdp"])
def test_meshes_beyond_one_device_are_refused(capsys, args):
    rc, out, err = _port(capsys, "--steps", "1", "--device", "cpu", *args)
    assert rc == 1 and not out
    assert "multi-device slice" in _error_line(err)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main.run(["--steps", "1", "--batch", "1", "--seq", "8"])
