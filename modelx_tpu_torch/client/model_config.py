"""modelx.yaml model-config schema (counterpart of
``modelx_tpu/client/model_config.py``): the same fields and the same
defaults, read with the port's own YAML reader (``utils/miniyaml.py``),
since the card's host has no pyyaml. A file outside the reader's subset
raises ``ValueError``, which the initializer answers by pulling every blob,
as it answers an invalid file. Configs are written with the JAX package's
``ModelConfig.to_yaml`` (``modelx init``) or by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from modelx_tpu_torch.utils import miniyaml

MODEL_CONFIG_FILENAME = "modelx.yaml"
README_FILENAME = "README.md"


@dataclasses.dataclass
class ServingConfig:
    """Serving hints: model family, mesh spec (a hint on one card), dtype."""

    model_family: str = ""  # e.g. "llama"
    mesh: str = ""  # e.g. "dp=1,tp=8"
    dtype: str = "bfloat16"
    topology: str = ""
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelConfig:
    description: str = ""
    framework: str = ""
    task: str = ""
    tags: list[str] = dataclasses.field(default_factory=list)
    resources: dict[str, Any] = dataclasses.field(default_factory=dict)
    maintainers: list[str] = dataclasses.field(default_factory=list)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    model_files: list[str] = dataclasses.field(default_factory=list)
    config: Any = None
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    @classmethod
    def from_yaml(cls, text: str | bytes) -> "ModelConfig":
        d = miniyaml.loads(text) or {}
        if not isinstance(d, dict):
            raise ValueError("modelx.yaml must be a mapping")
        sv = d.get("serving", {}) or {}
        return cls(
            description=d.get("description", "") or "",
            framework=d.get("framework", "") or "",
            task=d.get("task", "") or "",
            tags=list(d.get("tags", []) or []),
            resources=dict(d.get("resources", {}) or {}),
            maintainers=list(d.get("maintainers", []) or []),
            annotations=dict(d.get("annotations", {}) or {}),
            model_files=list(d.get("modelFiles", []) or []),
            config=d.get("config"),
            serving=ServingConfig(
                model_family=sv.get("model_family", "") or "",
                mesh=sv.get("mesh", "") or "",
                dtype=sv.get("dtype", "bfloat16") or "bfloat16",
                topology=sv.get("topology", "") or "",
                extra={k: v for k, v in sv.items() if k not in ("model_family", "mesh", "dtype", "topology")},
            ),
        )

    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        with open(path, "rb") as f:
            return cls.from_yaml(f.read())
