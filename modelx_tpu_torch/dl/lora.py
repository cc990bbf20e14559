"""LoRA adapter loading: merge PEFT-style adapters into base weights
(counterpart of ``modelx_tpu/dl/lora.py``).

At serve time the adapter is merged into the base weights on load
(W <- W + (alpha/r)·B@A), so serving costs exactly what the base costs: no
per-token adapter matmuls, no extra device memory beyond the merge's
transient.

Name mapping follows the PEFT safetensors convention:
``base_model.model.<target>.lora_A.weight`` ([r, in]) and ``...lora_B.weight``
([out, r]) merge into ``<target>.weight``. ``adapter_config.json`` beside the
adapter supplies ``lora_alpha``/``r`` when present (scale alpha/r); absent,
the scale is 1.0.

The delta is the JAX package's bytes: ``B @ A`` in numpy fp32 on the host,
times the scale, rounded to the base dtype (round to nearest even, as
``ml_dtypes`` rounds) and added on the device in the base dtype.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

from modelx_tpu_torch.dl import safetensors as st
from modelx_tpu_torch.ops.quant import QTensor

_LORA_KEY = re.compile(r"^(?:base_model\.model\.)?(.+)\.lora_(A|B)\.weight$")


def parse_adapter_dir(adapter_dir: str) -> tuple[float, dict[str, dict[str, np.ndarray]]]:
    """Read every *.safetensors under ``adapter_dir``; returns
    (scale, {target tensor name: {"A": [r,in], "B": [out,r]}}), the arrays
    in fp32.

    Unrecognized tensor names (e.g. PEFT ``modules_to_save`` retrained
    weights) are an error, not a skip: serving an adapter with parts of the
    fine-tune dropped is worse than refusing to start."""
    pairs: dict[str, dict[str, np.ndarray]] = {}
    unrecognized: list[str] = []
    paths = sorted(glob.glob(os.path.join(adapter_dir, "*.safetensors")))
    if not paths:
        raise ValueError(f"no safetensors under adapter dir {adapter_dir}")
    for path in paths:
        for name, t in st.read_tensors(path).items():
            m = _LORA_KEY.match(name)
            if not m:
                unrecognized.append(name)
                continue
            target = m.group(1) + ".weight"
            pairs.setdefault(target, {})[m.group(2)] = t.to(torch.float32).numpy()
    if unrecognized:
        raise ValueError(
            "adapter has non-LoRA tensors this server cannot merge "
            f"(modules_to_save?): {unrecognized[:3]}"
            + ("..." if len(unrecognized) > 3 else "")
        )
    incomplete = [t for t, ab in pairs.items() if set(ab) != {"A", "B"}]
    if incomplete:
        raise ValueError(f"adapter pairs missing A or B for: {incomplete[:3]}")
    if not pairs:
        raise ValueError(f"no lora_A/lora_B tensors found under {adapter_dir}")

    scale = 1.0
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        # per-module ranks/alphas mean a single global alpha/r scale would
        # mis-scale some targets: refuse rather than mis-serve
        for key in ("rank_pattern", "alpha_pattern"):
            if cfg.get(key):
                raise ValueError(
                    f"adapter_config.json has {key}: per-module LoRA "
                    "scales are not supported (a single global scale "
                    "would silently mis-merge some targets)"
                )
        r = cfg.get("r") or next(iter(pairs.values()))["A"].shape[0]
        mismatched = {
            t: ab["A"].shape[0] for t, ab in pairs.items() if ab["A"].shape[0] != r
        }
        if mismatched:
            raise ValueError(
                f"adapter ranks differ from adapter_config.json r={r}: "
                f"{dict(list(mismatched.items())[:3])} — refusing to merge "
                "with a wrong global scale"
            )
        alpha = cfg.get("lora_alpha", r)
        if cfg.get("use_rslora"):
            # rank-stabilized LoRA scales by alpha/sqrt(r)
            scale = float(alpha) / float(r) ** 0.5
        else:
            scale = float(alpha) / float(r)
    return scale, pairs


def merge_adapter(params: dict, adapter_dir: str) -> dict:
    """Fold the adapter into ``params`` (returns the dict). Quantized
    (QTensor) targets are rejected: the merge must happen before weight-only
    quantization, not after the precision was dropped."""
    scale, pairs = parse_adapter_dir(adapter_dir)
    missing = [t for t in pairs if t not in params]
    if missing:
        raise ValueError(
            f"adapter targets not in base model: {missing[:3]}"
            + ("..." if len(missing) > 3 else "")
        )
    for target, ab in pairs.items():
        base = params[target]
        if isinstance(base, QTensor) or not isinstance(base, torch.Tensor):
            raise ValueError(
                f"cannot merge adapter into non-array weight {target!r} "
                "(quantized? merge adapters before --quantize)"
            )
        a, b = ab["A"], ab["B"]
        if b.shape[1] != a.shape[0] or (b.shape[0], a.shape[1]) != tuple(base.shape):
            raise ValueError(
                f"adapter shapes for {target!r} do not match: "
                f"B{b.shape} @ A{a.shape} vs base {tuple(base.shape)}"
            )
        delta = torch.from_numpy(scale * (b @ a)).to(base.dtype)
        params[target] = base + delta.to(base.device)
    return params
