"""The port stands alone: no jax, ml_dtypes, tokenizers or modelx_tpu
imports, none of the packages the card's host lacks (regex, requests,
click, yaml, rich, cryptography, boto3, google, orbax, optax), and an explicit device
with no silent CPU fallback. The fleet router imports no torch at all: it
runs on boxes with no accelerator."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from modelx_tpu_torch.device import parse_dtype, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "tokenizers", "regex", "modelx_tpu",
             "requests", "click", "yaml", "rich", "cryptography", "boto3", "google", "orbax",
             "optax")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_serve_profile.py"),
             os.path.join(REPO, "scripts", "torch_flash_ab.py"),
             os.path.join(REPO, "tests", "test_torch_build.py"),
             os.path.join(REPO, "tests", "test_torch_kernels_cuda.py"),
             os.path.join(REPO, "tests", "test_torch_pool_cuda.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "modelx_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_or_reference_package():
    files = _port_files()
    assert len(files) > 10
    for new in ("dl/tokenizer.py", "dl/openai_api.py", "dl/lora.py", "ops/quant.py",
                "models/speculative.py", "types.py", "errors.py", "utils/retry.py",
                "utils/miniyaml.py", "client/remote.py", "client/pull.py",
                "client/model_config.py", "client/extension.py", "dl/blob_cache.py",
                "dl/manifest_cache.py", "dl/initializer.py", "dl/dl_main.py", "dl/ttft.py",
                "registry/server.py", "registry/store_fs.py", "registry/server_main.py",
                "dl/lifecycle.py", "dl/tiers.py", "utils/devmem.py", "utils/flightrec.py",
                "dl/continuous.py", "ops/paged_attention.py", "utils/promexp.py",
                "native/__init__.py", "cli.py", "version.py", "utils/units.py",
                "registry/sigv4.py", "registry/fs_s3.py", "registry/store_s3.py",
                "registry/fs_gcs.py", "registry/store_gcs.py", "registry/auth.py",
                "registry/gc.py", "registry/scrub.py", "client/extension_s3.py",
                "client/extension_gcs.py", "client/push.py", "client/ops.py",
                "client/convert.py", "dl/podspec.py", "testing/faults.py",
                "router/__init__.py", "router/http.py", "router/policy.py",
                "router/registry.py", "router/admission.py", "router/rebalance.py",
                "router/server.py", "router/router_main.py", "models/train.py",
                "models/train_main.py", "dl/checkpoint.py", "ops/moe.py", "ops/attention.py",
                "analysis/lint.py", "analysis/lockdep.py", "analysis/pytest_lockdep.py",
                "analysis/rules/locks.py", "analysis/rules/handlers.py",
                "analysis/rules/purity.py", "analysis/rules/threads.py", "dl/unigram.py",
                "dl/precompiled.py", "dl/unicode_tables.py", "testing/charsmap.py"):
        assert os.path.join(REPO, "modelx_tpu_torch", *new.split("/")) in files
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def _console_script_modules():
    """The modules behind the port's console scripts in pyproject.toml."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return sorted(v.split(":")[0] for v in scripts.values() if v.startswith("modelx_tpu_torch."))


def test_serving_entry_leaves_jax_unimported():
    scripts = _console_script_modules()
    assert scripts == ["modelx_tpu_torch.cli", "modelx_tpu_torch.dl.dl_main",
                       "modelx_tpu_torch.dl.serve_main",
                       "modelx_tpu_torch.models.train_main",
                       "modelx_tpu_torch.registry.server_main",
                       "modelx_tpu_torch.router.router_main"]
    code = (
        # namespace packages a site-packages .pth file registers at start-up
        # (``google``, ``google.cloud`` from some installs) hold no code;
        # any other forbidden module in sys.modules fails the test
        "import sys; ns = {m for m, mod in list(sys.modules.items()) "
        "if getattr(mod, '__file__', None) is None and hasattr(mod, '__path__')}; "
        f"import {', '.join(scripts)}; "
        "import modelx_tpu_torch.dl.serve_main, modelx_tpu_torch.dl.loader, "
        "modelx_tpu_torch.dl.weights, modelx_tpu_torch.models.llama, "
        "modelx_tpu_torch.dl.openai_api, modelx_tpu_torch.dl.tokenizer, "
        "modelx_tpu_torch.models.decode, modelx_tpu_torch.kernels.build, "
        "modelx_tpu_torch.dl.lora, modelx_tpu_torch.ops.quant, "
        "modelx_tpu_torch.models.speculative, modelx_tpu_torch.dl.dl_main, "
        "modelx_tpu_torch.dl.ttft, modelx_tpu_torch.dl.initializer, "
        "modelx_tpu_torch.client.client, modelx_tpu_torch.client.reference, "
        "modelx_tpu_torch.registry.server_main, modelx_tpu_torch.dl.lifecycle, "
        "modelx_tpu_torch.dl.tiers, modelx_tpu_torch.utils.devmem, "
        "modelx_tpu_torch.utils.flightrec, modelx_tpu_torch.dl.continuous, "
        "modelx_tpu_torch.ops.paged_attention, modelx_tpu_torch.utils.promexp, "
        "modelx_tpu_torch.native, modelx_tpu_torch.registry.store_s3, "
        "modelx_tpu_torch.registry.store_gcs, modelx_tpu_torch.registry.auth, "
        "modelx_tpu_torch.registry.gc, modelx_tpu_torch.client.push, "
        "modelx_tpu_torch.client.ops, modelx_tpu_torch.client.convert, "
        "modelx_tpu_torch.dl.podspec, modelx_tpu_torch.testing.faults, "
        "modelx_tpu_torch.dl.program_store, modelx_tpu_torch.models.train, "
        "modelx_tpu_torch.dl.checkpoint, modelx_tpu_torch.ops.moe, "
        "modelx_tpu_torch.dl.unigram, modelx_tpu_torch.dl.precompiled, "
        "modelx_tpu_torch.dl.unicode_tables, modelx_tpu_torch.testing.charsmap; "
        "bad = [m for m in sys.modules if m not in ns and m.split('.')[0] in "
        f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_unicode_tables_regenerate_to_the_committed_module():
    """``scripts/torch_unicode_tables.py`` builds the tables from ``regex``
    and holds each against ``tokenizers`` over every code point; run here,
    it gives the committed ``dl/unicode_tables.py`` byte for byte."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "torch_unicode_tables.py")
    spec = importlib.util.spec_from_file_location("torch_unicode_tables", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    lines: list[str] = []
    text = gen.build(log=lines.append)
    with open(os.path.join(REPO, "modelx_tpu_torch", "dl", "unicode_tables.py"),
              encoding="utf-8") as f:
        assert text == f.read(), lines
    assert any(line.startswith("graphemes:") for line in lines)


def test_resolve_device_raises_without_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_parse_dtype():
    assert parse_dtype("bfloat16") is torch.bfloat16
    assert parse_dtype("float32") is torch.float32
    assert parse_dtype(torch.float32) is torch.float32
    for bad in ("float16", torch.int8):
        with pytest.raises(ValueError, match="unsupported dtype"):
            parse_dtype(bad)


def test_the_router_imports_no_torch():
    """``modelx_tpu_torch.router`` and ``modelx-route-torch --help`` run
    with no torch (and no numpy) in ``sys.modules``."""
    code = (
        "import sys, contextlib, io\n"
        "import modelx_tpu_torch.router\n"
        "from modelx_tpu_torch.router import router_main\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    try:\n"
        "        router_main.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "assert '--pod' in out.getvalue() and 'modelx-route-torch' in out.getvalue()\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy'))\n"
        "print(heavy); sys.exit(1 if heavy else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
