"""The port's ``modelx-torch`` CLI (modelx_tpu_torch/cli.py, argparse)
against the JAX package's click CLI (``CliRunner``), on the CPU: each
ported command (init, login, list in its three modes, info, push, pull,
copy, diff, verify, repo add/list/remove, gc, scrub, convert torch,
programs and kv list/push/prune, completion and the hidden ``__complete``,
and their failures) gives the same output and exit code, the JAX CLI
against one registry and the port's against a twin that took the same
commands; ``serve``, ``serve-model``, ``route`` and ``dl`` hand their
arguments over to the port's entry points, and ``serve`` and ``route``
take the JAX commands' flags with their defaults. Where the two differ by
design, the test says how: ``convert orbax`` is refused here, ``programs
push`` bundles the kernel's library (the JAX CLI lists and prunes it the
same), a click usage error's wording is click's.

Normalized before comparing: the registry's address, the program name in
messages (``modelx-torch`` for ``modelx``), the JAX CLI's rich progress
lines (the card's host has no rich; the port draws none), and ``init``'s
scaffold, which names the port's framework (its files are compared with
their own readers instead). Tolerance: exact equality after that.
"""

import contextlib
import io
import json
import os
import re

import pytest
import yaml
from click.testing import CliRunner

from modelx_tpu.cli import main as jax_cli
from modelx_tpu_torch import cli
from modelx_tpu_torch.client.model_config import ModelConfig
from modelx_tpu_torch.registry.fs import MemoryFSProvider
from modelx_tpu_torch.registry.server import Options, RegistryServer, free_port
from modelx_tpu_torch.registry.store_fs import FSRegistryStore
from modelx_tpu_torch.utils import miniyaml


# a rich progress row: name, bar, "done/total unit", speed
PROGRESS = re.compile(r"^\S+ .*[\d.]+/[\d.]+ ?(bytes|kB|MB|GB)\s+\S+\s*$")
DIGEST = re.compile(r"sha256:[0-9a-f]{64}")


def _registry(tokens=()):
    srv = RegistryServer(Options(listen=f"127.0.0.1:{free_port()}", auth_tokens=tokens),
                         store=FSRegistryStore(MemoryFSProvider()))
    return srv, srv.serve_background()


class Twins:
    """The JAX CLI against registry A and the port's against registry B,
    each with its own HOME and working directory."""

    def __init__(self, root, tokens=()) -> None:
        self.jsrv, self.jbase = _registry(tokens)
        self.tsrv, self.tbase = _registry(tokens)
        self.jhome, self.thome = root / "jhome", root / "thome"
        self.jcwd, self.tcwd = root / "jcwd", root / "tcwd"
        for d in (self.jhome, self.thome, self.jcwd, self.tcwd):
            d.mkdir()

    def _norm(self, text: str, base: str) -> str:
        text = text.replace(base, "<registry>").replace(base.split("//")[1], "<host>")
        lines = [ln for ln in text.splitlines(keepends=True) if not PROGRESS.match(ln)]
        # a failed push names the first blob whose HEAD failed, which the
        # worker pool's order decides
        lines = [DIGEST.sub("<digest>", ln) if ln.startswith("error:") else ln for ln in lines]
        return "".join(lines).replace("modelx-torch", "modelx")

    def jax(self, *argv):
        argv = [a.replace("@REG", self.jbase).replace("@HOST", self.jbase.split("//")[1])
                for a in argv]
        cwd = os.getcwd()
        os.chdir(self.jcwd)
        try:
            # wide enough that rich's table truncates no cell (the port's
            # table never truncates)
            res = CliRunner().invoke(jax_cli, argv, env={"HOME": str(self.jhome),
                                                         "COLUMNS": "250"})
        finally:
            os.chdir(cwd)
        return res.exit_code, self._norm(res.output, self.jbase)

    def port(self, *argv, monkeypatch=None):
        argv = [a.replace("@REG", self.tbase).replace("@HOST", self.tbase.split("//")[1])
                for a in argv]
        out = io.StringIO()
        cwd, home = os.getcwd(), os.environ.get("HOME")
        os.chdir(self.tcwd)
        os.environ["HOME"] = str(self.thome)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
                try:
                    rc = cli.main(list(argv))
                except SystemExit as e:  # argparse usage errors
                    rc = e.code
        finally:
            os.chdir(cwd)
            if home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = home
        return rc, self._norm(out.getvalue(), self.tbase)

    def both(self, *argv):
        return self.jax(*argv), self.port(*argv)

    def close(self) -> None:
        self.jsrv.shutdown()
        self.tsrv.shutdown()


@pytest.fixture
def twins(tmp_path):
    t = Twins(tmp_path)
    yield t
    t.close()


def _model(cwd, name="m"):
    d = cwd / name
    d.mkdir()
    (d / "modelx.yaml").write_text("description: cli twin\nframework: pytorch\n"
                                   "serving:\n  mesh: dp=1\n")
    (d / "weights.bin").write_bytes(bytes(range(256)) * 300)
    (d / "notes.txt").write_text("notes\n")
    sub = d / "tok"
    sub.mkdir()
    (sub / "vocab.txt").write_text("a\nb\n")
    for f in (d / "modelx.yaml", d / "weights.bin", d / "notes.txt", sub / "vocab.txt"):
        os.utime(f, (1_700_000_000, 1_700_000_000))  # the same mtimes in both twins
    return d


def _push_both(twins):
    for cwd in (twins.jcwd, twins.tcwd):
        _model(cwd)
    return twins.both("push", "@REG/library/demo@v1", "m")


def test_push_output_equal(twins):
    (jrc, jout), (trc, tout) = _push_both(twins)
    assert (trc, tout) == (jrc, jout) == (0, "pushed <registry>/library/demo@v1\n")


@pytest.mark.parametrize("ref", ["@REG", "@REG/library/demo", "@REG/library/demo@v1",
                                 "@REG/library/nope", "@REG/library/demo@nope",
                                 "@REG/?search=dem", "nosuchalias/library/demo"])
def test_list_output_equal(twins, ref):
    _push_both(twins)
    j, t = twins.both("list", ref)
    assert t == j


@pytest.mark.parametrize("ref", ["@REG/library/demo@v1", "@REG/library/demo@nope"])
def test_info_output_equal(twins, ref):
    _push_both(twins)
    j, t = twins.both("info", ref)
    assert t == j


def test_pull_output_equal(twins):
    _push_both(twins)
    j, t = twins.both("pull", "@REG/library/demo@v1", "out")
    assert t == j == (0, "pulled <registry>/library/demo@v1 -> out\n")
    for rel in ("weights.bin", "notes.txt", "tok/vocab.txt", "modelx.yaml"):
        assert (twins.tcwd / "out" / rel).read_bytes() == (twins.jcwd / "out" / rel).read_bytes()
    j, t = twins.both("pull", "@REG/library/demo@v1")  # into the repository's name
    assert t == j and (twins.tcwd / "demo" / "weights.bin").exists()


@pytest.mark.parametrize("argv", [["gc", "@REG/library/demo"],
                                  ["gc", "@REG/library/demo", "--grace", "0"],
                                  ["gc", "@REG/library/nope"],
                                  ["scrub", "@REG/library/demo"],
                                  ["scrub", "@REG/library/demo", "--sample", "2", "--seed", "3"],
                                  ["scrub", "@REG"]])
def test_gc_and_scrub_output_equal(twins, argv):
    _push_both(twins)
    j, t = twins.both(*argv)
    assert t == j


def test_scrub_of_a_corrupt_repository_exits_1(twins):
    _push_both(twins)
    for srv in (twins.jsrv, twins.tsrv):
        store = srv.registry.store
        digest = next(b.digest for b in store.get_manifest("library/demo", "v1").blobs
                      if b.name == "weights.bin")
        store.fs.put(f"library/demo/blobs/sha256/{digest.split(':')[1]}", io.BytesIO(b"bad"), 3)
    j, t = twins.both("scrub", "@REG/library/demo")
    assert t == j and t[0] == 1 and json.loads(t[1])["quarantined"] == [digest]


def test_push_failures_equal(twins):
    j, t = twins.both("push", "@REG/library/demo@v1", "missing-dir")
    assert t == j and t[0] == 1
    _model(twins.jcwd)
    _model(twins.tcwd)
    j, t = twins.both("push", "@REG", "m")
    assert t == j == (1, "error: reference must include a repository\n")


def test_repo_commands_output_equal(twins):
    steps = [["repo", "list"], ["repo", "add", "a", "http://example.test:1"],
             ["repo", "add", "b", "ftp://nope"], ["repo", "add", "c", "https://c.test", "--token",
                                                  "tk"],
             ["repo", "list"], ["repo", "remove", "a"], ["repo", "remove", "a"], ["repo", "list"]]
    for argv in steps:
        j, t = twins.both(*argv)
        assert t == j, argv
    assert (twins.thome / ".modelx" / "repos.json").read_text() == \
        (twins.jhome / ".modelx" / "repos.json").read_text()


def test_login_then_alias_refs(tmp_path):
    twins = Twins(tmp_path, tokens=("tok",))
    try:
        for argv in (["login", "@REG", "--token", "bad"], ["login", "@REG", "--token", "tok"],
                     ["login", "@REG", "--token", "tok", "--name", "reg"], ["repo", "list"]):
            j, t = twins.both(*argv)
            assert t == j, argv
        _model(twins.jcwd)
        _model(twins.tcwd)
        for argv in (["push", "reg/library/demo@v1", "m"], ["list", "reg/library/demo@v1"],
                     ["list", "@HOST/library/demo"], ["push", "@REG/library/demo@v2", "m"]):
            j, t = twins.both(*argv)
            assert t == j, argv
    finally:
        twins.close()


def test_init_scaffolds_a_port_config(twins):
    j, t = twins.both("init", "m")
    assert t == j == (0, "initialized m/modelx.yaml\n")
    text = (twins.tcwd / "m" / "modelx.yaml").read_text()
    assert miniyaml.loads(text) == yaml.safe_load(text)
    cfg = ModelConfig.from_yaml(text)
    assert (cfg.framework, cfg.serving.mesh, cfg.resources) == (
        "pytorch", "dp=1", {"nvidia.com/gpu": 1})
    d = yaml.safe_load(text)
    assert yaml.safe_dump(d, sort_keys=False) == text  # what pyyaml would write
    j, t = twins.both("init", "m")  # refuses to overwrite
    assert t == j and t[0] == 1
    assert "modelx-torch push" in (twins.tcwd / "m" / "README.md").read_text()


def test_serve_takes_the_jax_serve_flags(monkeypatch, tmp_path):
    """``modelx-torch serve`` (modelxd-torch) builds the Options ``modelx
    serve`` builds from the same flags, defaults included."""
    import modelx_tpu.registry.server as jserver
    from modelx_tpu_torch.registry import server_main

    captured = {}

    class Capture:
        def __init__(self, opts):
            captured["opts"] = opts

        def serve_forever(self):
            pass

    monkeypatch.setattr(jserver, "RegistryServer", Capture)
    flags = [[], ["--listen", ":9", "--data", str(tmp_path), "--s3-url", "http://s3:9",
                  "--s3-access-key", "a", "--s3-secret-key", "s", "--s3-bucket", "bk",
                  "--s3-region", "eu-west-1", "--enable-redirect", "--no-local-redirect",
                  "--auth-token", "t1", "--auth-token", "t2", "--oidc-issuer", "https://i",
                  "--gc-interval", "30", "--no-reconcile-on-start"],
             ["--gcs-url", "http://g", "--gcs-access-key", "ga", "--gcs-secret-key", "gs",
              "--gcs-bucket", "gb"]]
    for argv in flags:
        res = CliRunner().invoke(jax_cli, ["serve", *argv])
        assert res.exit_code == 0, res.output
        want = captured["opts"].__dict__
        got = server_main.options(argv).__dict__
        assert got == want


def test_pass_through_commands_hand_over(twins, monkeypatch):
    calls = []
    from modelx_tpu_torch.dl import dl_main, serve_main
    from modelx_tpu_torch.registry import server_main

    for mod in (dl_main, serve_main, server_main):
        monkeypatch.setattr(mod, "main", lambda argv, m=mod.__name__: calls.append((m, argv)) or 0)
    assert cli.main(["serve", "--listen", ":1"]) == 0
    assert cli.main(["--debug", "serve-model", "--model", "m=/x", "--help"]) == 0
    assert cli.main(["dl", "ref", "dest", "--device-put"]) == 0
    assert calls == [("modelx_tpu_torch.registry.server_main", ["--listen", ":1"]),
                     ("modelx_tpu_torch.dl.serve_main", ["--model", "m=/x", "--help"]),
                     ("modelx_tpu_torch.dl.dl_main", ["ref", "dest", "--device-put"])]


def test_dl_pulls_through_the_cli(twins):
    _push_both(twins)
    rc, out = twins.port("dl", "@REG/library/demo@v1", "dest")
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["blobs"] == 3 and summary["pull"]["downloaded"] == 4  # + modelx.yaml
    assert (twins.tcwd / "dest" / "tok" / "vocab.txt").read_text() == "a\nb\n"


# -- copy, diff, verify, convert, programs, kv, completion, route --------------------


def _norm_completion(text: str) -> str:
    return text.replace("_MODELX_TORCH_COMPLETE", "_MODELX_COMPLETE")


@pytest.mark.parametrize("argv", [
    ["copy", "@REG/library/demo@v1", "@REG/library/copy@v1"],
    ["copy", "--quiet", "@REG/library/demo@v1", "@REG/library/copy"],
    ["copy", "@REG/library/demo", "@REG/library/copy@v1"],
    ["copy", "@REG", "@REG/library/copy@v1"],
    ["copy", "@REG/library/nope@v1", "@REG/library/copy@v1"],
    ["diff", "@REG/library/demo@v1", "@REG/library/demo@v2"],
    ["diff", "@REG/library/demo@v1", "@REG/library/demo"],
    ["diff", "@REG/library/demo@v1", "@REG"],
    ["verify", "@REG/library/demo"],
    ["verify", "--quiet", "@REG/library/demo@v1"],
    ["verify", "--remote", "@REG/library/demo"],
    ["verify", "--remote", "@REG/library/demo@v1"],
    ["verify", "@REG"],
])
def test_copy_diff_verify_output_equal(twins, argv):
    _push_both(twins)
    for cwd in (twins.jcwd, twins.tcwd):
        (cwd / "m" / "notes.txt").write_text("notes, second edition\n")
    twins.both("push", "@REG/library/demo@v2", "m")
    j, t = twins.both(*argv)
    assert t == j
    if argv[0] == "copy" and t[0] == 0:  # the second copy moves nothing
        j, t = twins.both(*argv)
        assert t == j and json.loads(t[1].splitlines()[-1])["bytes"] == 0


def test_verify_of_a_corrupt_blob_exits_1(twins):
    _push_both(twins)
    for srv in (twins.jsrv, twins.tsrv):
        store = srv.registry.store
        digest = next(b.digest for b in store.get_manifest("library/demo", "v1").blobs
                      if b.name == "weights.bin")
        store.fs.put(f"library/demo/blobs/sha256/{digest.split(':')[1]}", io.BytesIO(b"bad"), 3)
    for argv in (["verify", "@REG/library/demo"], ["verify", "--remote", "@REG/library/demo"]):
        j, t = twins.both(*argv)
        assert t == j and t[0] == 1, argv


def test_convert_torch_output_equal_and_orbax_refused(twins):
    import torch

    for cwd in (twins.jcwd, twins.tcwd):
        torch.save({"state_dict": {"module.w": torch.ones(2, 3, dtype=torch.bfloat16),
                                   "module.b": torch.arange(4)}, "epoch": 2},
                   str(cwd / "ckpt.pt"))
    for argv in (["convert", "torch", "ckpt.pt", "out", "--rename", "module.="],
                 ["convert", "torch", "ckpt.pt", "out2", "--rename", "bad"],
                 ["convert", "torch", "missing.pt", "out3"]):
        j, t = twins.both(*argv)
        assert t[0] == j[0], argv
        if t[0] == 0:
            assert t == j
        else:  # torch.load's own message names the missing file the same way
            assert t[1].startswith("error: ") and j[1].startswith("error: ")
    assert (twins.tcwd / "out" / "model.safetensors").read_bytes() == \
        (twins.jcwd / "out" / "model.safetensors").read_bytes()
    rc, out = twins.port("convert", "orbax", "ckpt", "out4")
    assert rc == 1 and out.startswith("error: cannot convert ckpt:")
    assert "`modelx convert orbax SRC DST_DIR`" in out and not (twins.tcwd / "out4").exists()


def _kv_bundle():
    from modelx_tpu_torch.dl import kv_store
    from tests.test_torch_kv_store import IDS, fake_entry

    return kv_store.build_bundle(IDS, fake_entry(), model_key="m1")


def test_kv_commands_output_equal(twins):
    _push_both(twins)
    data = _kv_bundle()
    for cwd in (twins.jcwd, twins.tcwd):
        (cwd / "b.tar").write_bytes(data)
        (cwd / "junk.tar").write_bytes(b"not a tar")
    for argv in (["kv", "list", "@REG/library/demo"], ["kv", "push", "@REG/library/demo", "b.tar"],
                 ["kv", "push", "@REG/library/demo@v1", "junk.tar"],
                 ["kv", "push", "@REG/library/demo@v1", "missing.tar"],
                 ["kv", "push", "@REG/library/demo@v1", "b.tar"],
                 ["kv", "push", "@REG/library/demo@v1", "b.tar"],
                 ["kv", "list", "@REG/library/demo@v1"], ["kv", "list", "@REG/library/demo"],
                 ["kv", "prune", "@REG/library/demo@v1"], ["kv", "prune", "@REG/library/demo"],
                 ["kv", "list", "@REG"]):
        j, t = twins.both(*argv)
        if argv[-1] == "junk.tar":
            # the JAX CLI ends on the tar reader's traceback; the port says
            # what it meant to
            assert (t[0], j[0], t[1]) == (1, 1, "error: junk.tar is not a kv bundle "
                                                "(bad tar/meta)\n")
            continue
        if argv[-1] == "missing.tar":
            # click checks the path exists before the command runs (a usage
            # error, 2); the port's open fails in the command (1)
            assert (t[0], j[0]) == (1, 2) and "missing.tar" in t[1] and "missing.tar" in j[1]
            continue
        assert t == j, argv


def test_programs_commands(twins, monkeypatch, tmp_path):
    """The refusals and the listing equal the JAX CLI's; a push bundles the
    kernel's library (a stand-in file under its name here: no nvcc on the
    CPU), and the JAX CLI lists and prunes the port's bundle the same way."""
    from modelx_tpu_torch.kernels import build

    _push_both(twins)
    for argv in (["programs", "list", "@REG/library/demo"],
                 ["programs", "push", "@REG/library/demo"],
                 ["programs", "push", "@REG/library/demo@v1"],
                 ["programs", "push", "@REG/library/demo@v1", "--quantize", "int4"],
                 ["programs", "prune", "@REG/library/demo"],
                 ["programs", "list", "@REG"]):
        j, t = twins.both(*argv)
        if "int4" in argv:  # a usage error: both exit 2 (the wording is each parser's)
            assert t[0] == j[0] == 2 and "int4" in t[1] and "int4" in j[1]
            continue
        assert t == j, argv
    # a one-layer llama at head_dim 64 (one the kernel takes); a build dir
    # with no library and no nvcc: the typed refusal
    import torch

    from modelx_tpu_torch.dl import safetensors as tst
    from modelx_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=640, intermediate_size=64, num_layers=1,
                            num_heads=10, num_kv_heads=2, head_dim=64, dtype=torch.float32)
    (twins.tcwd / "llama").mkdir()
    tst.write_safetensors(str(twins.tcwd / "llama" / "model.safetensors"),
                          llama.init_params(cfg, torch.Generator().manual_seed(0)))
    (twins.tcwd / "llama" / "modelx.yaml").write_text("description: tiny\n")
    assert twins.port("push", "@REG/library/tiny@v1", "llama")[0] == 0
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-toolkit"))
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    empty = tmp_path / "empty-cache"
    empty.mkdir()
    rc, out = twins.port("programs", "push", "@REG/library/tiny@v1", "--cache-dir", str(empty))
    assert rc == 1 and "nvcc not found" in out and "holds no cached library" in out
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / build.library_name()).write_bytes(b"a stand-in kernel library")
    rc, out = twins.port("programs", "push", "@REG/library/tiny@v1", "--cache-dir", str(cache),
                         "--quantize", "int8")
    assert rc == 0, out
    pushed = json.loads(out)
    assert (pushed["programs"], pushed["family"]) == (1, "llama")
    assert sorted(pushed) == ["digest", "family", "name", "programs", "size"]
    # the JAX CLI reads the port's registry: the same listing before and
    # after the port's prune
    for argv in (["programs", "list", "@REG/library/tiny@v1"],
                 ["programs", "prune", "@REG/library/tiny"],
                 ["programs", "list", "@REG/library/tiny"]):
        t = twins.port(*argv)
        if argv[1] == "prune":
            assert t == (0, '{"removed": 1, "versions": 1}\n')
            continue
        assert t == twins.jax(*[a.replace("@REG", twins.tbase) for a in argv]), argv
        assert (pushed["name"] in t[1]) == ("@v1" in argv[2])


@pytest.mark.parametrize("shell", ["bash", "zsh", "fish", "powershell", "tcsh"])
def test_completion_output_equal(twins, shell):
    j, t = twins.both("completion", shell)
    assert (t[0], _norm_completion(t[1])) == (j[0], j[1]) if shell != "tcsh" else \
        t[0] == j[0] == 2


def test_completion_scripts_call_the_backend(monkeypatch, capsys):
    for shell in ("bash", "zsh", "fish"):
        monkeypatch.setenv("_MODELX_TORCH_COMPLETE", f"{shell}_source")
        assert cli.main([]) == 0
        script = capsys.readouterr().out
        assert "modelx-torch __complete --" in script, shell


@pytest.mark.parametrize("words", [[""], ["c"], ["-"], ["push", ""], ["push", "r"],
                                   ["push", "reg/"], ["push", "reg/library/"],
                                   ["pull", "reg/library/demo@"], ["copy", "reg/library/demo@v1", "reg/l"],
                                   ["diff", "a", "reg/library/d"], ["push", "reg/library/demo", ""],
                                   ["verify", "-"], ["serve", ""], ["nope", "reg/"],
                                   ["--debug", "list", "reg/"]])
def test_hidden_complete_candidates_equal(twins, words):
    _push_both(twins)
    twins.both("repo", "add", "reg", "@REG")
    j, t = twins.both("__complete", "--", *words)
    assert t == j


def test_route_hands_over(twins, monkeypatch):
    from modelx_tpu_torch.router import router_main

    calls = []
    monkeypatch.setattr(router_main, "main",
                        lambda argv, prog: calls.append((argv, prog)) or 0)
    assert cli.main(["route", "--pod", "http://p:1", "--listen", ":9"]) == 0
    assert calls == [(["--pod", "http://p:1", "--listen", ":9"], "modelx-torch route")]


def test_route_takes_the_jax_route_flags():
    """``modelx-route-torch`` has every flag of ``modelx-route`` with its
    default (click's option names and defaults against argparse's)."""
    from modelx_tpu.router.router_main import main as jroute
    from modelx_tpu_torch.router import router_main

    ap = router_main.build_parser()
    ours = {a.option_strings[0]: a.default for a in ap._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    theirs = {p.opts[0]: (None if p.multiple else p.default) for p in jroute.params}
    assert ours == theirs
    args = ap.parse_args(["--pod", "http://a:1", "--pod", "http://b:2", "--allow-rebalance",
                          "--breaker-threshold", "3", "--retry-budget", "0.2"])
    router = router_main.build_router(args)
    snap = router.snapshot()
    assert [p for p in snap["pods"]["pods"]] == ["http://a:1", "http://b:2"]
    assert snap["breakers"]["threshold"] == 3 and snap["retry_budget"]["ratio"] == 0.2
    assert snap["rebalance"]["enabled"] is True
