"""chip_smoke.py off the card: it refuses to report without CUDA or without
the port beside it, and its serving phase rehearses end to end on the CPU
at a tiny size (the wrapper's plain version, no kernel launches)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke
from modelx_tpu_torch.models import llama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_attention_bound_counts_visible_pairs():
    # the serving shape: causal, 2*B*H*S^2*D ~ 34 GFLOP at 989 TFLOP/s
    ms, by = chip_smoke.attention_bound(1, 32, 8, 2048, 128, True, 0, "bfloat16")
    assert by == "operations" and ms == pytest.approx(4 * 128 * 2048 * 2049 / 2 * 32 / 989e9)
    assert chip_smoke.visible_pairs(5, True, 2) == 1 + 2 + 2 + 2 + 2
    assert chip_smoke.visible_pairs(5, False, 2) == 25
    _, by = chip_smoke.attention_bound(2, 16, 4, 512, 64, True, 0, "bfloat16")
    assert by == "bytes"


def test_main_phase_rehearses_on_cpu(monkeypatch):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024), rope_theta=500000.0)
    monkeypatch.setattr(chip_smoke, "FORWARD_SHAPES", ((1, 48), (2, 16)))
    monkeypatch.setattr(chip_smoke, "GENERATE_PROMPTS", (5, 12))
    monkeypatch.setattr(chip_smoke, "NEW_TOKENS", 3)
    stats = chip_smoke.phase_main(device="cpu", cfg=cfg)
    assert stats["flash_launches"] == 0  # CPU tensors take the plain version
    assert stats["logit_max_diff"] == 0.0 and stats["argmax_checked"] > 0
    assert {"forward_ms_1x48", "forward_ms_2x16", "generate_s_5", "generate_s_12"} <= set(stats)
