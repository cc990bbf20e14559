"""The port's GPU pod spec (modelx_tpu_torch/dl/podspec.py) against the
JAX package's TPU spec, on the CPU: the same metadata, volume, ports and
probes (readiness ``/healthz``, liveness ``/livez``, with the reference's
timings); the init container runs ``modelxdl-torch`` and the serving
container ``modelx-serve-torch --model-dir /mnt/models --dtype ...``, and
both the serving container's limits and requests ask for the
``nvidia.com/gpu`` count modelx.yaml names; nothing names a TPU
(``assert_gpu``). The serving command parses with the port's sidecar
flags, ``--model-dir`` serving the model named ``default``.
"""

import json

import pytest

from modelx_tpu.client.model_config import ModelConfig as JConfig
from modelx_tpu.dl.podspec import generate_pod_spec as jspec
from modelx_tpu_torch.client.model_config import ModelConfig
from modelx_tpu_torch.dl import podspec

YAML = "description: d\nframework: pytorch\nresources:\n  nvidia.com/gpu: {n}\nserving:\n  dtype: {dt}\n"


@pytest.mark.parametrize("n,dt", [(1, "bfloat16"), (4, "float32")])
def test_gpu_spec_keeps_the_reference_shape(n, dt):
    text = YAML.format(n=n, dt=dt)
    spec = podspec.generate_pod_spec("llama-3-8b", "http://reg/library/llama@v1",
                                     ModelConfig.from_yaml(text))
    ref = jspec("llama-3-8b", "http://reg/library/llama@v1", JConfig.from_yaml(text))
    podspec.assert_gpu(spec)
    assert spec["metadata"] == ref["metadata"] and spec["spec"]["volumes"] == \
        ref["spec"]["volumes"]
    init, serve = spec["spec"]["initContainers"][0], spec["spec"]["containers"][0]
    rinit, rserve = ref["spec"]["initContainers"][0], ref["spec"]["containers"][0]
    assert init["command"] == ["modelxdl-torch", "http://reg/library/llama@v1", "/mnt/models"]
    assert rinit["command"] == ["modelx", "dl", "http://reg/library/llama@v1", "/mnt/models"]
    assert serve["command"] == ["modelx-serve-torch", "--model-dir", "/mnt/models", "--dtype", dt]
    for key in ("ports", "volumeMounts", "readinessProbe", "livenessProbe", "name"):
        assert serve[key] == rserve[key], key
    assert init["volumeMounts"] == rinit["volumeMounts"] and init["name"] == rinit["name"]
    assert serve["resources"] == {"limits": {"nvidia.com/gpu": str(n)},
                                  "requests": {"nvidia.com/gpu": str(n)}}
    assert "nodeSelector" not in spec["spec"] and "google.com/tpu" not in json.dumps(spec)
    assert "google.com/tpu" in json.dumps(ref)


def test_defaults_and_refusals():
    spec = podspec.generate_pod_spec("m", "http://r/l/m@v1", ModelConfig())
    assert spec["spec"]["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert spec["spec"]["containers"][0]["command"][-1] == "bfloat16"
    for bad in ("0", "many"):
        with pytest.raises(ValueError, match="nvidia.com/gpu"):
            podspec.generate_pod_spec("m", "u", ModelConfig.from_yaml(
                f"resources:\n  nvidia.com/gpu: {bad}\n"))
    tpu = podspec.generate_pod_spec("m", "u", ModelConfig())
    tpu["spec"]["containers"][0]["resources"] = {"limits": {"google.com/tpu": "8"}}
    with pytest.raises(AssertionError, match="TPU"):
        podspec.assert_gpu(tpu)
    tpu["spec"]["containers"][0]["resources"] = {}
    with pytest.raises(AssertionError, match="asks for no nvidia.com/gpu"):
        podspec.assert_gpu(tpu)


def test_the_serving_command_parses_with_the_sidecar_flags():
    from modelx_tpu_torch.dl import serve_main

    spec = podspec.generate_pod_spec("m", "u", ModelConfig())
    argv = spec["spec"]["containers"][0]["command"][1:]
    args = serve_main.build_parser().parse_args(argv)
    assert (args.model_dir, args.dtype, args.models) == ("/mnt/models", "bfloat16", [])
    with pytest.raises(SystemExit):
        serve_main._start(["--device", "cpu"])  # neither --model-dir nor --model
