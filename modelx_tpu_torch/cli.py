"""`modelx-torch`: the user CLI of the port (counterpart of
``modelx_tpu/cli.py``), on argparse where the JAX package uses click.

    modelx-torch init DIR
    modelx-torch login http://registry:8080 --token T
    modelx-torch push http://registry:8080/library/llama@v1 DIR
    modelx-torch pull http://registry:8080/library/llama@v1 DIR
    modelx-torch list REF | info REF | gc REF [--grace S] | scrub REF
    modelx-torch copy SRC DST | diff A B | verify REF [--remote]
    modelx-torch programs list|push|prune REF | kv list|prune REF | kv push REF BUNDLE
    modelx-torch convert torch SRC DST_DIR [--rename OLD=NEW]
    modelx-torch repo add NAME URL [--token T] | repo list | repo remove NAME
    modelx-torch completion bash|zsh|fish|powershell
    modelx-torch serve ...        # the registry daemon (modelxd-torch)
    modelx-torch serve-model ...  # the serving sidecar (modelx-serve-torch)
    modelx-torch route ...        # the fleet router (modelx-route-torch)
    modelx-torch dl ...           # the deploy-time puller (modelxdl-torch)

Each command prints what the JAX CLI prints and exits with its code, with
these differences: transfers draw no progress bars (the card's host has no
rich); ``init`` scaffolds a modelx.yaml for this package (framework
``pytorch``, one GPU, mesh ``dp=1``); ``programs push`` bundles the flash
kernel's library, which is the port's only compiled program; ``convert
orbax`` is refused, since it needs orbax, which the port does not import;
completion scripts name ``modelx-torch``. ``serve``, ``serve-model``,
``route`` and ``dl`` hand their arguments over to the port's entry points
verbatim. A ``--debug`` or ``--insecure`` flag goes before the command.
"""

from __future__ import annotations

import argparse
import getpass
import json
import logging
import os
import sys
import tarfile
from urllib.parse import urlparse

from modelx_tpu_torch import errors
from modelx_tpu_torch.client.client import Client
from modelx_tpu_torch.client.model_config import (
    MODEL_CONFIG_FILENAME, README_FILENAME, ModelConfig,
)
from modelx_tpu_torch.client.reference import parse_reference
from modelx_tpu_torch.client.repo import RepoDetails, default_repo_manager
from modelx_tpu_torch.utils.units import human_size

PROG = "modelx-torch"

INIT_README = """# {name}

A model packaged with modelx. Edit `modelx.yaml` to describe the model, then:

    modelx-torch push <repo>/<project>/{name}@<version> .
"""


class Failed(Exception):
    """A command's failure: ``error: <message>`` on stderr, exit code 1."""


def _table(headers: list[str], rows: list[list]) -> None:
    """Columns padded to their widths and two spaces apart, the layout of
    the JAX CLI's borderless rich table."""
    cells = [headers] + [[str(c) for c in row] for row in rows]
    widths = [max(len(row[i]) for row in cells) for i in range(len(headers))]
    for row in cells:
        print("  ".join(c.ljust(w) for c, w in zip(row, widths)))


# -- commands ------------------------------------------------------------------


def cmd_init(args) -> int:
    directory = args.directory
    os.makedirs(directory, exist_ok=True)
    cfg_path = os.path.join(directory, MODEL_CONFIG_FILENAME)
    if os.path.exists(cfg_path):
        raise Failed(FileExistsError(f"{cfg_path} already exists"))
    cfg = ModelConfig(
        description="my model description",
        framework="pytorch",
        task="text-generation",
        tags=["llm"],
        maintainers=["maintainer@example.com"],
        model_files=[],
        resources={"nvidia.com/gpu": 1},
    )
    cfg.serving.mesh = "dp=1"
    cfg.serving.dtype = "bfloat16"
    with open(cfg_path, "w") as f:
        f.write(cfg.to_yaml())
    readme = os.path.join(directory, README_FILENAME)
    if not os.path.exists(readme):
        with open(readme, "w") as f:
            f.write(INIT_README.format(name=os.path.basename(os.path.abspath(directory))))
    print(f"initialized {cfg_path}")
    return 0


def cmd_login(args) -> int:
    token = args.token if args.token is not None else getpass.getpass("Token: ")
    Client(args.registry, "Bearer " + token, quiet=True).ping()
    alias = args.name or urlparse(args.registry).netloc
    default_repo_manager().set(RepoDetails(name=alias, url=args.registry.rstrip("/"),
                                           token=token))
    print(f"login succeeded; saved as repo alias {alias!r}")
    return 0


def cmd_list(args) -> int:
    r = parse_reference(args.ref)
    client = r.client(quiet=True)
    if not r.repository:
        idx = client.get_global_index(args.search)
        _table(["NAME", "SIZE", "MODIFIED"],
               [[m.name, human_size(m.size), m.modified] for m in idx.manifests])
    elif not r.version:
        idx = client.get_index(r.repository, args.search)
        _table(["VERSION", "SIZE", "MODIFIED"],
               [[m.name, human_size(m.size), m.modified] for m in idx.manifests])
    else:
        m = client.get_manifest(r.repository, r.version)
        _table(["FILE", "TYPE", "SIZE", "DIGEST"],
               [[d.name, d.media_type.rsplit(".", 1)[-1], human_size(d.size), d.digest[:19]]
                for d in m.all_descriptors()])
    return 0


def cmd_info(args) -> int:
    r = parse_reference(args.ref)
    content = r.client(quiet=True).get_config_content(r.repository, r.version)
    print(content.decode(errors="replace"))
    return 0


def cmd_push(args) -> int:
    cfg_path = os.path.join(args.directory, MODEL_CONFIG_FILENAME)
    if not os.path.isfile(cfg_path):
        raise Failed(FileNotFoundError(f"{cfg_path} not found — run `{PROG} init` first"))
    ModelConfig.load(cfg_path)  # validate before pushing
    r = parse_reference(args.ref)
    if not r.repository:
        raise Failed(ValueError("reference must include a repository"))
    r.client().push(r.repository, r.version or "latest", args.directory)
    print(f"pushed {r}")
    return 0


def cmd_pull(args) -> int:
    r = parse_reference(args.ref)
    target = args.directory or r.repository.rsplit("/", 1)[-1]
    r.client().pull(r.repository, r.version or "latest", target)
    print(f"pulled {r} -> {target}")
    return 0


def cmd_gc(args) -> int:
    r = parse_reference(args.ref)
    print(json.dumps(r.client(quiet=True).remote.garbage_collect(r.repository,
                                                                 grace_s=args.grace)))
    return 0


def cmd_scrub(args) -> int:
    r = parse_reference(args.ref)
    if not r.repository:
        raise ValueError("reference must include a repository")
    out = r.client(quiet=True).remote.scrub(r.repository, sample=args.sample, seed=args.seed)
    print(json.dumps(out))
    return 0 if out.get("clean", False) else 1


def _refs(*refs: str):
    """Parsed references that must each name a repository."""
    parsed = [parse_reference(r) for r in refs]
    if not all(r.repository for r in parsed):
        raise ValueError("both references must include a repository" if len(refs) > 1
                         else "reference must include a repository")
    return parsed


def _log(quiet: bool):
    return (lambda line: None) if quiet else print


def cmd_copy(args) -> int:
    from modelx_tpu_torch.client.ops import copy_model

    s, d = _refs(args.src, args.dst)
    if not s.version:
        raise ValueError("source reference needs a version (repo@version)")
    out = copy_model(s.client().remote, s.repository, s.version,
                     d.client().remote, d.repository, d.version or s.version,
                     log=_log(args.quiet))
    print(json.dumps(out))
    return 0


def cmd_diff(args) -> int:
    from modelx_tpu_torch.client.ops import diff_versions

    ra, rb = _refs(args.a, args.b)
    if not ra.version or not rb.version:
        raise ValueError("both references need a version (repo@version)")
    print(json.dumps(diff_versions(ra.client().remote, ra.repository, ra.version,
                                   rb.client().remote, rb.repository, rb.version)))
    return 0


def _versions(remote, r) -> list[str]:
    """``r``'s version, or every version of its repository."""
    return [r.version] if r.version else [m.name for m in
                                          remote.get_index(r.repository).manifests]


def cmd_verify(args) -> int:
    from modelx_tpu_torch.client.ops import verify_repo
    from modelx_tpu_torch.types import MediaTypeModelProgram

    (r,) = _refs(args.ref)
    if args.remote:
        if r.version:
            raise ValueError("--remote scrubs the whole repository; drop the @version "
                             "(or verify that version locally without --remote)")
        remote = r.client(quiet=True).remote
        out = remote.scrub(r.repository)
        # the scrub result is blob-level: count the program bundles among
        # the verified blobs client-side
        out["program_blobs"] = sum(
            1 for ver in _versions(remote, r)
            for b in remote.get_manifest(r.repository, ver).blobs
            if b.media_type == MediaTypeModelProgram)
        print(json.dumps(out))
        return 0 if out.get("clean", False) else 1
    out = verify_repo(r.client().remote, r.repository, r.version, log=_log(args.quiet))
    print(json.dumps(out))
    return 1 if out["errors"] else 0


def _bundle_rows(r, media_type: str, keys: tuple) -> list[list]:
    """One table row per bundle of ``media_type`` attached to ``r``'s
    version(s): version, name, the ``keys`` annotations, size."""
    remote = r.client(quiet=True).remote
    rows = []
    for ver in _versions(remote, r):
        for b in remote.get_manifest(r.repository, ver).blobs:
            if b.media_type == media_type:
                rows.append([ver, b.name, *(b.annotations.get(k, "?") for k in keys),
                             human_size(b.size)])
    return rows


def _prune(r, media_type: str) -> dict:
    """Detach every ``media_type`` descriptor from ``r``'s version(s)."""
    remote = r.client(quiet=True).remote
    versions = _versions(remote, r)
    removed = 0
    for ver in versions:
        manifest = remote.get_manifest(r.repository, ver)
        keep = [b for b in manifest.blobs if b.media_type != media_type]
        if len(keep) == len(manifest.blobs):
            continue
        removed += len(manifest.blobs) - len(keep)
        manifest.blobs = keep
        remote.put_manifest(r.repository, ver, manifest)
    return {"removed": removed, "versions": len(versions)}


def cmd_programs_list(args) -> int:
    from modelx_tpu_torch.types import (
        AnnotationProgramBackend, AnnotationProgramCode, AnnotationProgramCount,
        AnnotationProgramJax, MediaTypeModelProgram,
    )

    (r,) = _refs(args.ref)
    _table(["VERSION", "BUNDLE", "PROGRAMS", "JAX", "BACKEND", "CODE", "SIZE"],
           _bundle_rows(r, MediaTypeModelProgram,
                        (AnnotationProgramCount, AnnotationProgramJax,
                         AnnotationProgramBackend, AnnotationProgramCode)))
    return 0


def cmd_programs_push(args) -> int:
    from modelx_tpu_torch.dl import program_store
    from modelx_tpu_torch.kernels import build

    r = parse_reference(args.ref)
    if not r.repository or not r.version:
        raise ValueError("programs push needs repo@version "
                         "(bundles pin the exact version they compile for)")
    client = r.client(quiet=True)
    try:
        manifest = client.get_manifest(r.repository, r.version)
        family, cfg, head_dims, mesh = program_store.plan_from_manifest(
            client, r.repository, manifest, quantize=args.quantize)
        cache_dir = args.cache_dir or build.build_dir()
        keys = program_store.export_surface(family, cfg, head_dims, mesh, cache_dir)
        data = program_store.build_bundle(cache_dir, keys=keys, mesh=mesh) if keys else None
        if data is None:
            raise ValueError("no programs exported; nothing to push")
        desc = program_store.publish(client.remote, r.repository, r.version, data)
    except OSError as e:
        raise Failed(e) from e
    print(json.dumps({"name": desc.name, "digest": str(desc.digest), "size": desc.size,
                      "programs": len(keys), "family": family.name}))
    return 0


def cmd_programs_prune(args) -> int:
    from modelx_tpu_torch.types import MediaTypeModelProgram

    (r,) = _refs(args.ref)
    print(json.dumps(_prune(r, MediaTypeModelProgram)))
    return 0


def cmd_kv_list(args) -> int:
    from modelx_tpu_torch.types import (
        AnnotationKVCode, AnnotationKVModel, AnnotationKVPrefix, AnnotationKVTokens,
        MediaTypeModelKVCache,
    )

    (r,) = _refs(args.ref)
    _table(["VERSION", "BUNDLE", "TOKENS", "PREFIX", "MODEL", "CODE", "SIZE"],
           _bundle_rows(r, MediaTypeModelKVCache,
                        (AnnotationKVTokens, AnnotationKVPrefix, AnnotationKVModel,
                         AnnotationKVCode)))
    return 0


def cmd_kv_push(args) -> int:
    from modelx_tpu_torch.dl import kv_store

    r = parse_reference(args.ref)
    if not r.repository or not r.version:
        raise ValueError("kv push needs repo@version "
                         "(bundles pin the exact version they cache for)")
    try:
        with open(args.bundle, "rb") as f:
            data = f.read()
        try:
            meta = kv_store._bundle_meta(data)
        except (tarfile.TarError, KeyError, ValueError):
            meta = None  # the JAX CLI ends here with the tar reader's traceback
        if meta is None:
            raise ValueError(f"{args.bundle} is not a kv bundle (bad tar/meta)")
        desc = kv_store.publish(r.client(quiet=True).remote, r.repository, r.version, data)
    except OSError as e:
        raise Failed(e) from e
    print(json.dumps({"name": desc.name, "digest": str(desc.digest), "size": desc.size,
                      "tokens": meta.get("tokens") and len(meta["tokens"])}))
    return 0


def cmd_kv_prune(args) -> int:
    from modelx_tpu_torch.types import MediaTypeModelKVCache

    (r,) = _refs(args.ref)
    print(json.dumps(_prune(r, MediaTypeModelKVCache)))
    return 0


def cmd_convert(args) -> int:
    from modelx_tpu_torch.client import convert

    fn = convert.convert_torch if args.format == "torch" else convert.convert_orbax
    try:
        out = fn(args.src, args.dst_dir, list(args.rename), log=print)
    except Exception as e:  # torch.load raises pickle and runtime errors for
        # checkpoints it cannot read: say "error: ...", not a traceback
        raise Failed(e) from e
    print(json.dumps(out))
    return 0


def cmd_repo_add(args) -> int:
    default_repo_manager().set(RepoDetails(name=args.name, url=args.url, token=args.token))
    print(f"added repo {args.name} -> {args.url}")
    return 0


def cmd_repo_list(args) -> int:
    _table(["NAME", "URL", "TOKEN"],
           [[r.name, r.url, "yes" if r.token else ""] for r in default_repo_manager().list()])
    return 0


def cmd_repo_remove(args) -> int:
    if not default_repo_manager().remove(args.name):
        raise Failed(KeyError(f"no such repo alias: {args.name}"))
    print(f"removed repo {args.name}")
    return 0


def cmd_version(args) -> int:
    from modelx_tpu_torch.version import get

    print(str(get()))
    return 0


# -- completion --------------------------------------------------------------------

# every shell completes through the hidden `modelx-torch __complete` backend:
# `completion SHELL` prints the line that evaluates the script below, as
# the JAX CLI prints click's (the JAX CLI's powershell script is the same
# hand-rolled one)
COMPLETE_VAR = "_MODELX_TORCH_COMPLETE"
_SHELL_SCRIPTS = {
    "bash": r"""
_modelx_torch_completion() {
    local IFS=$'
'
    COMPREPLY=($(modelx-torch __complete -- "${COMP_WORDS[@]:1:COMP_CWORD}" 2>/dev/null))
}
complete -o default -F _modelx_torch_completion modelx-torch
""",
    "zsh": r"""
#compdef modelx-torch
_modelx_torch_completion() {
    local -a candidates
    candidates=("${(@f)$(modelx-torch __complete -- "${(@)words[2,$CURRENT]}" 2>/dev/null)}")
    compadd -a candidates
}
compdef _modelx_torch_completion modelx-torch
""",
    "fish": r"""
function __modelx_torch_completion
    set -l words (commandline -opc)
    modelx-torch __complete -- $words[2..-1] (commandline -ct) 2>/dev/null
end
complete -c modelx-torch -f -a '(__modelx_torch_completion)'
""",
    "powershell": r"""
Register-ArgumentCompleter -Native -CommandName modelx-torch -ScriptBlock {
    param($wordToComplete, $commandAst, $cursorPosition)
    # AST tokens exclude trailing whitespace; $wordToComplete is '' exactly
    # when the cursor sits after a space, i.e. a fresh argument position
    $words = @($commandAst.ToString().Split(" ") | Where-Object { $_ -ne "" } | Select-Object -Skip 1)
    if ([string]::IsNullOrEmpty($wordToComplete)) { $words = $words + "" }
    modelx-torch __complete -- @($words) 2>$null | ForEach-Object {
        [System.Management.Automation.CompletionResult]::new($_, $_, 'ParameterValue', $_)
    }
}
""",
}


def cmd_completion(args) -> int:
    if args.shell == "powershell":
        print(_SHELL_SCRIPTS["powershell"].strip())
    else:
        print(f'eval "$({COMPLETE_VAR}={args.shell}_source {PROG})"')
    return 0


def _complete_ref(incomplete: str) -> list[str]:
    """Remote completion of ``alias/repository[@version]`` by querying the
    registry indexes (the JAX CLI's ``_complete_ref``)."""
    try:
        mgr = default_repo_manager()
        if "/" not in incomplete:
            return [r.name + "/" for r in mgr.list() if r.name.startswith(incomplete)]
        alias, _, rest = incomplete.partition("/")
        details = mgr.get(alias)
        if details is None:
            return []
        client = Client(details.url, "Bearer " + details.token if details.token else "",
                        quiet=True)
        client.remote.timeout = (2, 2)  # Tab completion must never hang the shell
        if "@" in rest:
            repo, _, ver = rest.partition("@")
            idx = client.get_index(repo)
            return [f"{alias}/{repo}@{m.name}" for m in idx.manifests if m.name.startswith(ver)]
        return [cand for cand in (f"{alias}/{m.name}" for m in client.get_global_index().manifests)
                if cand.startswith(incomplete)]
    except Exception:
        return []  # completion must never crash the shell


# commands whose FIRST positional argument is a model reference; later
# positions are directories (filename completion is the shell's own job),
# except for copy and diff, whose second position is a ref too
_REF_COMMANDS = ("push", "pull", "info", "list", "gc", "dl", "copy", "verify", "diff", "scrub")


def cmd_hidden_complete(words: list[str]) -> int:
    """``modelx-torch __complete -- <words...>``: one candidate per line;
    the last word is the one being completed (may be empty)."""
    if words[:1] == ["--"]:
        words = words[1:]
    words = words or [""]
    incomplete, prior = words[-1], words[:-1]
    try:
        args = [w for w in prior if not w.startswith("-")]
        if not args:  # completing the command itself
            if not incomplete.startswith("-"):
                for name in COMMANDS:
                    if name.startswith(incomplete):
                        print(name)
            return 0
        ref_positions = 2 if args[0] in ("copy", "diff") else 1
        if (args[0] in _REF_COMMANDS and len(args) <= ref_positions
                and not incomplete.startswith("-")):
            for cand in _complete_ref(incomplete):
                print(cand)
    except Exception:
        pass  # completion must never fail the shell
    return 0


# -- the entry point -------------------------------------------------------------


def _serve(argv: list[str]) -> int:
    from modelx_tpu_torch.registry import server_main

    return server_main.main(argv)


def _serve_model(argv: list[str]) -> int:
    from modelx_tpu_torch.dl import serve_main

    return serve_main.main(argv)


def _dl(argv: list[str]) -> int:
    from modelx_tpu_torch.dl import dl_main

    return dl_main.main(argv)


def _route(argv: list[str]) -> int:
    from modelx_tpu_torch.router import router_main

    return router_main.main(argv, prog=f"{PROG} route")


# commands whose arguments pass through to another entry point verbatim
PASS_THROUGH = {"serve": _serve, "serve-model": _serve_model, "route": _route, "dl": _dl,
                "__complete": cmd_hidden_complete}

# the visible commands, in the JAX CLI's order (what `__complete` offers)
COMMANDS = ("init", "login", "list", "info", "push", "pull", "copy", "diff", "verify", "scrub",
            "repo", "gc", "programs", "kv", "serve", "serve-model", "route", "dl", "convert",
            "version", "completion")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=PROG, description="modelx registry CLI of the port.")
    ap.add_argument("--debug", action="store_true", default=bool(os.environ.get("DEBUG")),
                    help="verbose logging")
    ap.add_argument("--insecure", action="store_true",
                    help="skip TLS certificate verification (self-signed registries)")
    sub = ap.add_subparsers(dest="command", required=True, metavar="COMMAND")

    def command(name, fn, help_, parent=sub):
        p = parent.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p

    def group(name, help_):
        return sub.add_parser(name, help=help_).add_subparsers(
            dest=f"{name}_command", required=True, metavar="COMMAND")

    p = command("init", cmd_init, "scaffold modelx.yaml + README.md")
    p.add_argument("directory", nargs="?", default=".")
    p = command("login", cmd_login, "verify a token against the registry, then store it")
    p.add_argument("registry")
    p.add_argument("--token", default=None, help="bearer token (prompted for when absent)")
    p.add_argument("--name", default="", help="alias name (defaults to host)")
    p = command("list", cmd_list, "list repositories, versions or files")
    p.add_argument("ref")
    p.add_argument("--search", default="", help="regex filter")
    p = command("info", cmd_info, "print a version's modelx.yaml")
    p.add_argument("ref")
    p = command("push", cmd_push, "push a model directory (needs modelx.yaml)")
    p.add_argument("ref")
    p.add_argument("directory", nargs="?", default=".")
    p = command("pull", cmd_pull, "pull a model version into a directory")
    p.add_argument("ref")
    p.add_argument("directory", nargs="?", default="")
    p = command("copy", cmd_copy, "copy a model version between registries/repos; blobs "
                                  "the destination holds move zero bytes")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--quiet", action="store_true", help="suppress per-blob progress lines")
    p = command("diff", cmd_diff, "manifest-level diff of two model versions")
    p.add_argument("a")
    p.add_argument("b")
    p = command("verify", cmd_verify, "re-hash every blob a repository's manifests reference "
                                      "(exit 1 on any mismatch)")
    p.add_argument("ref")
    p.add_argument("--quiet", action="store_true", help="suppress per-blob lines")
    p.add_argument("--remote", action="store_true",
                   help="verify server-side via the scrub route (no pull): the registry "
                        "re-hashes its own blobs and quarantines corruption in place; "
                        "repository-wide, so no @version")
    p = command("scrub", cmd_scrub, "server-side integrity scrub of a repository")
    p.add_argument("ref")
    p.add_argument("--sample", type=int, default=0,
                   help="re-hash only N blobs, drawn from --seed (0 = everything)")
    p.add_argument("--seed", type=int, default=0, help="sample seed")
    rsub = group("repo", "repository alias management (~/.modelx/repos.json)")
    p = command("add", cmd_repo_add, None, rsub)
    p.add_argument("name")
    p.add_argument("url")
    p.add_argument("--token", default="")
    command("list", cmd_repo_list, None, rsub)
    p = command("remove", cmd_repo_remove, None, rsub)
    p.add_argument("name")
    p = command("gc", cmd_gc, "server-side garbage collection of a repository")
    p.add_argument("ref")
    p.add_argument("--grace", type=float, default=None,
                   help="skip blobs younger than this many seconds (default: the server's "
                        "window; 0 sweeps immediately and may race in-flight pushes)")
    psub = group("programs", "program bundles: the kernel library shipped with the model")
    command("list", cmd_programs_list, "list the program bundles of a version (or of "
                                       "every version)", psub).add_argument("ref")
    p = command("push", cmd_programs_push, "build (or find) the flash kernel's library for "
                                           "a version's head_dim and attach it", psub)
    p.add_argument("ref")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="accepted for the JAX CLI's flag; changes nothing here: int8 "
                        "weight-only linears leave the kernel library as it is")
    p.add_argument("--cache-dir", default="",
                   help="directory to find or build the library in (default: the build "
                        "directory, $MODELX_COMPILE_CACHE when set)")
    command("prune", cmd_programs_prune, "detach program bundles from a version (or every "
                                         "version)", psub).add_argument("ref")
    ksub = group("kv", "prefix-KV bundles: serialized prefill caches shipped with the model")
    command("list", cmd_kv_list, "list the prefix-KV bundles of a version (or of every "
                                 "version)", ksub).add_argument("ref")
    p = command("push", cmd_kv_push, "attach a pre-built prefix-KV bundle to a version", ksub)
    p.add_argument("ref")
    p.add_argument("bundle")
    command("prune", cmd_kv_prune, "detach prefix-KV bundles from a version (or every "
                                   "version)", ksub).add_argument("ref")
    for name, help_ in (("serve", "run the registry daemon (modelxd-torch)"),
                        ("serve-model", "run the serving sidecar (modelx-serve-torch)"),
                        ("route", "run the fleet router (modelx-route-torch)"),
                        ("dl", "the deploy-time puller (modelxdl-torch)")):
        sub.add_parser(name, help=help_, add_help=False)
    csub = group("convert", "convert foreign checkpoints to a pushable safetensors dir")
    for fmt, help_ in (("orbax", "orbax PyTree checkpoint: refused here (needs orbax)"),
                       ("torch", "torch state_dict (.bin/.pt) -> DST_DIR/model.safetensors")):
        p = command(fmt, cmd_convert, help_, csub)
        p.set_defaults(format=fmt)
        p.add_argument("src")
        p.add_argument("dst_dir")
        p.add_argument("--rename", action="append", default=[], metavar="OLD=NEW",
                       help="prefix rewrite applied to tensor names (repeatable)")
    command("version", cmd_version, "print the version")
    p = command("completion", cmd_completion, "emit a shell completion script")
    p.add_argument("shell", choices=["bash", "zsh", "fish", "powershell"])
    return ap


def main(argv=None) -> int:
    script = os.environ.get(COMPLETE_VAR, "")
    if script.endswith("_source") and script[:-7] in _SHELL_SCRIPTS:
        print(_SHELL_SCRIPTS[script[:-7]].strip())
        return 0
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = []
    while argv and argv[0] in ("--debug", "--insecure"):
        flags.append(argv.pop(0))
    if argv and argv[0] in PASS_THROUGH:
        _setup(debug="--debug" in flags, insecure="--insecure" in flags)
        return PASS_THROUGH[argv[0]](argv[1:])
    args = build_parser().parse_args(flags + argv)
    _setup(debug=args.debug, insecure=args.insecure)
    try:
        return args.fn(args)
    except Failed as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 1
    except (errors.ErrorInfo, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _setup(debug: bool, insecure: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if insecure:
        from modelx_tpu_torch.client.remote import set_insecure

        set_insecure(True)


if __name__ == "__main__":
    raise SystemExit(main())
