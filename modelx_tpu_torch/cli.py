"""`modelx-torch`: the user CLI of the port (counterpart of
``modelx_tpu/cli.py``), on argparse where the JAX package uses click.

    modelx-torch init DIR
    modelx-torch login http://registry:8080 --token T
    modelx-torch push http://registry:8080/library/llama@v1 DIR
    modelx-torch pull http://registry:8080/library/llama@v1 DIR
    modelx-torch list REF | info REF | gc REF [--grace S] | scrub REF
    modelx-torch repo add NAME URL [--token T] | repo list | repo remove NAME
    modelx-torch serve ...        # the registry daemon (modelxd-torch)
    modelx-torch serve-model ...  # the serving sidecar (modelx-serve-torch)
    modelx-torch dl ...           # the deploy-time puller (modelxdl-torch)

Each command prints what the JAX CLI prints and exits with its code, with
two differences: transfers draw no progress bars (the card's host has no
rich), and ``init`` scaffolds a modelx.yaml for this package (framework
``pytorch``, one GPU, mesh ``dp=1``). ``serve``, ``serve-model`` and
``dl`` hand their arguments over to the port's entry points verbatim.
A ``--debug`` or ``--insecure`` flag goes before the command.
"""

from __future__ import annotations

import argparse
import getpass
import json
import logging
import os
import sys
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


# commands whose arguments pass through to another entry point verbatim
PASS_THROUGH = {"serve": _serve, "serve-model": _serve_model, "dl": _dl}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=PROG, description="modelx registry CLI of the port.")
    ap.add_argument("--debug", action="store_true", default=bool(os.environ.get("DEBUG")),
                    help="verbose logging")
    ap.add_argument("--insecure", action="store_true",
                    help="skip TLS certificate verification (self-signed registries)")
    sub = ap.add_subparsers(dest="command", required=True, metavar="COMMAND")

    def command(name, fn, help_):
        p = sub.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p

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
    p = command("gc", cmd_gc, "server-side garbage collection of a repository")
    p.add_argument("ref")
    p.add_argument("--grace", type=float, default=None,
                   help="skip blobs younger than this many seconds (default: the server's "
                        "window; 0 sweeps immediately and may race in-flight pushes)")
    p = command("scrub", cmd_scrub, "server-side integrity scrub of a repository")
    p.add_argument("ref")
    p.add_argument("--sample", type=int, default=0,
                   help="re-hash only N blobs, drawn from --seed (0 = everything)")
    p.add_argument("--seed", type=int, default=0, help="sample seed")
    command("version", cmd_version, "print the version")
    repo = sub.add_parser("repo", help="repository alias management (~/.modelx/repos.json)")
    rsub = repo.add_subparsers(dest="repo_command", required=True, metavar="COMMAND")
    p = rsub.add_parser("add")
    p.set_defaults(fn=cmd_repo_add)
    p.add_argument("name")
    p.add_argument("url")
    p.add_argument("--token", default="")
    rsub.add_parser("list").set_defaults(fn=cmd_repo_list)
    p = rsub.add_parser("remove")
    p.set_defaults(fn=cmd_repo_remove)
    p.add_argument("name")
    for name, help_ in (("serve", "run the registry daemon (modelxd-torch)"),
                        ("serve-model", "run the serving sidecar (modelx-serve-torch)"),
                        ("dl", "the deploy-time puller (modelxdl-torch)")):
        sub.add_parser(name, help=help_, add_help=False)
    return ap


def main(argv=None) -> int:
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
