"""The port's ``modelx-torch`` CLI (modelx_tpu_torch/cli.py, argparse)
against the JAX package's click CLI (``CliRunner``), on the CPU: each
ported command (init, login, list in its three modes, info, push, pull,
repo add/list/remove, gc, scrub, and their failures) gives the same output
and exit code, the JAX CLI against one registry and the port's against a
twin that took the same commands; ``serve``, ``serve-model`` and ``dl``
hand their arguments over to the port's entry points, and ``serve`` takes
``modelx serve``'s flags with their defaults.

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
            res = CliRunner().invoke(jax_cli, argv, env={"HOME": str(self.jhome)})
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
