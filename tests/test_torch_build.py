"""kernels/build.py off the card: the cache key covers every file under
csrc/. scripts/torch_flash_ab.py, which builds other kernel sources beside
the port's, checks its baselines and refuses to run without a card."""

import argparse
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from modelx_tpu_torch.kernels import build

AB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "scripts", "torch_flash_ab.py")


def _load_ab():
    spec = importlib.util.spec_from_file_location("torch_flash_ab", AB)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_library_name_hashes_every_csrc_file(tmp_path, monkeypatch):
    for name in ("flash_attention.cu", "hopper.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    first = build.library_path()
    assert first == build.library_path()  # stable
    (tmp_path / "hopper.cuh").write_text("// a header changed\n")
    assert build.library_path() != first  # a header edit rebuilds
    (tmp_path / "new.cuh").write_text("")
    assert len({first, build.library_path()}) == 2


def test_the_real_sources_are_all_hashed():
    names = sorted(os.listdir(build.CSRC))
    assert "flash_attention.cu" in names and "hopper.cuh" in names
    assert os.path.basename(build.library_path()).startswith("flash_attention-")


def test_ab_script_refuses_a_baseline_without_a_kernel_source(tmp_path, capsys):
    ab = _load_ab()
    with pytest.raises(SystemExit) as exc:
        ab.main(["--baseline", f"old={tmp_path}"])
    assert exc.value.code == 2 and "no flash_attention.cu" in capsys.readouterr().err
    (tmp_path / "flash_attention.cu").write_text("")
    assert ab.parse_baseline(f"old={tmp_path}") == ("old", str(tmp_path))
    for bad in (str(tmp_path), f"port={tmp_path}", f"={tmp_path}"):
        with pytest.raises(argparse.ArgumentTypeError, match="NAME=DIR"):
            ab.parse_baseline(bad)


def test_ab_script_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs for real there")
    (tmp_path / "flash_attention.cu").write_text("")
    proc = subprocess.run([sys.executable, AB, "--baseline", f"old={tmp_path}"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"cases"' not in proc.stdout
