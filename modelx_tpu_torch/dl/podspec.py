"""Deploy-spec generation for a GPU serving pod (counterpart of
``modelx_tpu/dl/podspec.py``, which writes a TPU pod).

The reference deploys a model with the puller as an init container next to
the serving container. Here the init container runs ``modelxdl-torch`` into
the shared volume and the serving container runs ``modelx-serve-torch`` on
it; ``resources`` ask for ``nvidia.com/gpu`` (the count from modelx.yaml's
``resources``, one by default), never ``google.com/tpu``. The readiness
(``/healthz``) and liveness (``/livez``) probes are the reference's. The
spec is a dict; the port has no YAML writer, and ``json.dumps`` of it is a
valid manifest for ``kubectl apply -f``.
"""

from __future__ import annotations

import json

from modelx_tpu_torch.client.model_config import ModelConfig

GPU_RESOURCE = "nvidia.com/gpu"


def gpu_count(config: ModelConfig) -> int:
    """The GPUs modelx.yaml asks for (``resources: {nvidia.com/gpu: N}``,
    as ``modelx-torch init`` writes it); 1 when it names none."""
    try:
        n = int(config.resources.get(GPU_RESOURCE, 1))
    except (TypeError, ValueError):
        raise ValueError(f"modelx.yaml resources {GPU_RESOURCE!r} is not a count: "
                         f"{config.resources.get(GPU_RESOURCE)!r}") from None
    if n < 1:
        raise ValueError(f"modelx.yaml resources {GPU_RESOURCE!r} must be >= 1, got {n}")
    return n


def generate_pod_spec(
    name: str,
    uri: str,
    config: ModelConfig,
    image: str = "modelx-tpu-torch:latest",
    volume_size: str = "100Gi",
) -> dict:
    gpus = str(gpu_count(config))
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "labels": {"app": name, "modelx.io/model": name}},
        "spec": {
            "initContainers": [
                {
                    "name": "modelx-dl",
                    "image": image,
                    "command": ["modelxdl-torch", uri, "/mnt/models"],
                    "volumeMounts": [{"name": "model", "mountPath": "/mnt/models"}],
                }
            ],
            "containers": [
                {
                    "name": "serve",
                    "image": image,
                    "command": [
                        "modelx-serve-torch",
                        "--model-dir", "/mnt/models",
                        "--dtype", config.serving.dtype or "bfloat16",
                    ],
                    "ports": [{"containerPort": 8000, "name": "http"}],
                    "resources": {
                        "limits": {GPU_RESOURCE: gpus},
                        "requests": {GPU_RESOURCE: gpus},
                    },
                    "volumeMounts": [{"name": "model", "mountPath": "/mnt/models"}],
                    "readinessProbe": {
                        "httpGet": {"path": "/healthz", "port": 8000},
                        "initialDelaySeconds": 5,
                    },
                    # liveness is a separate, stricter probe: /livez fails
                    # only when the serving engine is circuit-broken (restart
                    # the pod); /healthz 503s for recoverable states too
                    # (loading, draining, an engine restart), which must
                    # drain traffic, not kill the container
                    "livenessProbe": {
                        "httpGet": {"path": "/livez", "port": 8000},
                        "initialDelaySeconds": 30,
                        "periodSeconds": 10,
                        "failureThreshold": 3,
                    },
                }
            ],
            "volumes": [{"name": "model", "emptyDir": {"sizeLimit": volume_size}}],
        },
    }


def assert_gpu(spec: dict) -> None:
    """The port's invariant: the serving container asks for GPUs, and
    nothing in the spec names a TPU."""
    text = json.dumps(spec)
    if "google.com/tpu" in text or "tpu" in json.dumps(spec.get("spec", {}).get("nodeSelector",
                                                                                   {})):
        raise AssertionError("generated pod spec references TPUs")
    serve = spec["spec"]["containers"][0]["resources"]
    if GPU_RESOURCE not in serve.get("limits", {}) or GPU_RESOURCE not in serve.get("requests",
                                                                                    {}):
        raise AssertionError(f"generated pod spec asks for no {GPU_RESOURCE}")
