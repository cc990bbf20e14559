"""The port's converter (modelx_tpu_torch/client/convert.py) against the
JAX package's, on the CPU: ``convert_torch`` writes a ``model.safetensors``
byte-identical to the JAX converter's for bf16, f16, f32, int64 and bool
tensors, non-contiguous ones, a lightning ``state_dict`` wrapper with
non-tensor entries, and ``--rename`` prefixes; its refusals (no tensors, a
bad or colliding rename) carry the same messages. A 0-d tensor is where the
two differ (ROADMAP §C.8): the port writes its shape ``[]``, the reference
``[1]``. ``convert orbax`` is refused with a message naming the JAX
package's command. Tolerance: exact bytes.
"""

import pytest
import torch

from modelx_tpu.client import convert as jconv
from modelx_tpu_torch.client import convert as tconv


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "module.embed.weight": torch.randn(7, 5, generator=g).to(torch.bfloat16),
        "module.norm.weight": torch.randn(5, generator=g),
        "module.head.weight": torch.randn(5, 6, generator=g).t(),  # non-contiguous
        "module.half": torch.randn(3, 2, generator=g).to(torch.float16),
        "module.ids": torch.arange(9, dtype=torch.int64),
        "module.mask": torch.tensor([True, False, True]),
    }


CASES = {
    "plain": (lambda: _state(), []),
    "lightning": (lambda: {"state_dict": _state(), "epoch": 3, "hparams": {"lr": 0.1}},
                  ["module.="]),
    "renames": (lambda: _state(), ["module.=model.", "model.embed=model.embed_tokens"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_torch_byte_identical(tmp_path, case):
    make, renames = CASES[case]
    src = str(tmp_path / "ckpt.pt")
    torch.save(make(), src)
    jlog, tlog = [], []
    jout = jconv.convert_torch(src, str(tmp_path / "j"), renames, log=jlog.append)
    tout = tconv.convert_torch(src, str(tmp_path / "t"), renames, log=tlog.append)
    assert {k: v for k, v in tout.items() if k != "path"} == \
        {k: v for k, v in jout.items() if k != "path"}
    assert [x.replace("/t/", "/j/") for x in tlog] == jlog
    assert (tmp_path / "t" / "model.safetensors").read_bytes() == \
        (tmp_path / "j" / "model.safetensors").read_bytes()


@pytest.mark.parametrize("renames", [["nope"], ["=x"], ["module.=", "embed.weight=norm.weight"],
                                     ["module.embed.weight=module.norm.weight"]])
def test_rename_refusals_equal(tmp_path, renames):
    src = str(tmp_path / "ckpt.pt")
    torch.save(_state(), src)
    with pytest.raises(ValueError) as je:
        jconv.convert_torch(src, str(tmp_path / "j"), renames)
    with pytest.raises(ValueError) as te:
        tconv.convert_torch(src, str(tmp_path / "t"), renames)
    assert str(te.value) == str(je.value)


def test_no_tensors_refused_the_same(tmp_path):
    src = str(tmp_path / "empty.pt")
    torch.save({"epoch": 1}, src)
    with pytest.raises(ValueError) as je:
        jconv.convert_torch(src, str(tmp_path / "j"))
    with pytest.raises(ValueError) as te:
        tconv.convert_torch(src, str(tmp_path / "t"))
    assert str(te.value) == str(je.value)


def test_convert_orbax_is_refused(tmp_path):
    with pytest.raises(tconv.OrbaxNotPortedError, match="modelx convert orbax") as e:
        tconv.convert_orbax(str(tmp_path / "ckpt"), str(tmp_path / "out"))
    assert isinstance(e.value, ValueError) and not (tmp_path / "out").exists()


def test_a_0d_tensor_keeps_its_shape_here(tmp_path):
    """The reference's writer passes each array through
    ``np.ascontiguousarray``, which makes a 0-d array 1-d, so a scalar
    (a step counter, a temperature) comes back as shape [1]; the port
    writes the safetensors shape [] and reads back the 0-d tensor it was
    given. The payload bytes are the same."""
    from modelx_tpu.dl import safetensors as jst
    from modelx_tpu_torch.dl import safetensors as tst

    src = str(tmp_path / "ckpt.pt")
    torch.save({"step": torch.tensor(3.5), "w": torch.ones(2)}, src)
    jconv.convert_torch(src, str(tmp_path / "j"))
    tconv.convert_torch(src, str(tmp_path / "t"))
    jh, _ = jst.read_header_from_file(str(tmp_path / "j" / "model.safetensors"))
    th, _ = tst.read_header_from_file(str(tmp_path / "t" / "model.safetensors"))
    assert (list(jh["step"].shape), list(th["step"].shape)) == ([1], [])
    got = tst.read_tensors(str(tmp_path / "t" / "model.safetensors"))
    assert got["step"].shape == () and got["step"].item() == 3.5
