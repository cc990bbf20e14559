"""Core of the AST lint: file walking, rule dispatch, baseline, reporting.

Stdlib-only (ast + os): the gate must run in any environment the port
builds in, including the card's host, without importing torch.

A rule is a callable ``rule(ctx) -> Iterable[Finding]`` registered in
``rules/__init__.py``; ``ctx`` is a :class:`ModuleContext` giving it the
parsed tree with parent links, the source, and scope helpers. Findings
are suppressed by ``baseline.toml`` entries keyed on (rule, file, scope)
— scope, not line number, so routine edits above a vetted site don't
resurrect it — and every entry must carry a written justification.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass, field

# the port's package and the scripts that drive it on the card (the JAX
# package's scripts/ neighbours are the reference's gate's to check)
DEFAULT_TARGETS = ("modelx_tpu_torch", "chip_smoke.py", "scripts/torch_flash_ab.py",
                   "scripts/torch_profiler_overhead.py", "scripts/torch_serve_profile.py")
_SKIP_DIRS = {"__pycache__", ".git", "_build", "node_modules", ".venv"}


@dataclass
class Finding:
    """One violation: where, what rule, and how to fix it."""

    rule: str
    file: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    hint: str = ""
    scope: str = ""  # dotted qualname of the enclosing def/class ("" = module)

    def key(self) -> tuple:
        return (self.file, self.line, self.col, self.rule)

    def render(self, show_hint: bool = True) -> str:
        where = f"{self.file}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        out = f"{where}: {self.rule}: {self.message}{scope}"
        if show_hint and self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Suppression:
    rule: str
    file: str
    scope: str = ""
    reason: str = ""
    used: int = field(default=0, compare=False)

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule or self.file != f.file:
            return False
        if not self.scope:
            return True
        return f.scope == self.scope or f.scope.startswith(self.scope + ".")


class BaselineError(Exception):
    """baseline.toml is malformed (bad syntax, missing reason, ...)."""


def _parse_baseline_toml(text: str, path: str) -> list[Suppression]:
    """Minimal TOML-subset parser for the baseline file (py3.10 has no
    tomllib, and the gate must stay dependency-free). Supported: comments,
    ``[[suppression]]`` table headers, and ``key = "string"`` pairs."""
    sups: list[Suppression] = []
    current: dict[str, str] | None = None

    def flush() -> None:
        nonlocal current
        if current is None:
            return
        missing = {"rule", "file", "reason"} - set(current)
        if missing:
            raise BaselineError(
                f"{path}: suppression {current} is missing {sorted(missing)} "
                "(every baseline entry must name its rule + file and carry a "
                "written justification in `reason`)"
            )
        if not current["reason"].strip():
            raise BaselineError(
                f"{path}: suppression for {current['rule']} at "
                f"{current['file']} has an empty reason; baseline entries "
                "require a written justification"
            )
        sups.append(Suppression(rule=current["rule"], file=current["file"],
                                scope=current.get("scope", ""),
                                reason=current["reason"]))
        current = None

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[suppression]]":
            flush()
            current = {}
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                val = val[1:-1]
            else:
                raise BaselineError(
                    f"{path}:{lineno}: value for {key!r} must be a "
                    f'double-quoted string, got {val!r}'
                )
            current[key] = val
            continue
        raise BaselineError(f"{path}:{lineno}: cannot parse line {raw!r}")
    flush()
    return sups


def load_baseline(path: str) -> list[Suppression]:
    with open(path, encoding="utf-8") as f:
        return _parse_baseline_toml(f.read(), path)


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.toml")


class ModuleContext:
    """One parsed module handed to every rule: tree with parent links,
    source lines, and scope helpers."""

    def __init__(self, path: str, rel: str, tree: ast.Module, source: str) -> None:
        self.path = path
        self.rel = rel
        self.tree = tree
        self.source = source
        self.lines = source.splitlines()
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def scope_of(self, node: ast.AST) -> str:
        """Dotted qualname of the innermost enclosing def/class chain."""
        parts: list[str] = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(anc.name)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def finding(self, rule: str, node: ast.AST, message: str, hint: str = "") -> Finding:
        return Finding(rule=rule, file=self.rel, line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0), message=message,
                       hint=hint, scope=self.scope_of(node))


def iter_python_files(targets, root: str):
    """Yield (abs_path, repo_relative_path) for every .py under targets."""
    for target in targets:
        top = target if os.path.isabs(target) else os.path.join(root, target)
        if os.path.isfile(top):
            yield top, os.path.relpath(top, root).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    p = os.path.join(dirpath, name)
                    yield p, os.path.relpath(p, root).replace(os.sep, "/")


def analyze_paths(targets, root: str = ".", rules=None) -> tuple[list[Finding], list[str]]:
    """Run every rule over every file. Returns (findings, errors) where
    errors are files that failed to parse (reported, non-fatal: a syntax
    error is the compiler's job, not the linter's)."""
    from modelx_tpu_torch.analysis.rules import all_rules

    active = rules if rules is not None else all_rules()
    findings: list[Finding] = []
    errors: list[str] = []
    for path, rel in iter_python_files(targets, root):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            errors.append(f"{rel}: {e}")
            continue
        ctx = ModuleContext(path, rel, tree, source)
        for rule in active:
            findings.extend(rule(ctx))
    findings.sort(key=Finding.key)
    return findings, errors


def apply_baseline(findings: list[Finding], sups: list[Suppression]):
    """Split findings into (new, suppressed); marks suppressions used."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        for s in sups:
            if s.matches(f):
                s.used += 1
                suppressed.append(f)
                break
        else:
            new.append(f)
    return new, suppressed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m modelx_tpu_torch.analysis",
        description="the port's concurrency/purity lint (see modelx_tpu_torch/analysis)",
    )
    parser.add_argument("targets", nargs="*", default=[],
                        help=f"files/dirs to scan (default: {', '.join(DEFAULT_TARGETS)})")
    parser.add_argument("--root", default=os.getcwd(),
                        help="repo root findings are reported relative to")
    parser.add_argument("--baseline", default="",
                        help="baseline.toml path (default: the checked-in one)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring the baseline")
    parser.add_argument("--rule", action="append", default=[],
                        help="run only these rule ids (repeatable)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="summary line only")
    args = parser.parse_args(argv)

    from modelx_tpu_torch.analysis.rules import all_rules, rule_catalog

    if args.list_rules:
        for rid, doc in rule_catalog().items():
            print(f"{rid}: {doc}")
        return 0

    rules = all_rules()
    if args.rule:
        unknown = set(args.rule) - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in args.rule]

    if args.targets:
        # a typo'd explicit target must not silently turn the gate green
        missing = [t for t in args.targets
                   if not os.path.exists(t)
                   and not os.path.exists(os.path.join(args.root, t))]
        if missing:
            print(f"error: target(s) not found: {', '.join(missing)}",
                  file=sys.stderr)
            return 2
        targets = args.targets
    else:
        targets = [
            t for t in DEFAULT_TARGETS if os.path.exists(os.path.join(args.root, t))
        ]
    findings, errors = analyze_paths(targets, root=args.root, rules=rules)

    sups: list[Suppression] = []
    if not args.no_baseline:
        baseline_path = args.baseline or default_baseline_path()
        if os.path.exists(baseline_path):
            try:
                sups = load_baseline(baseline_path)
            except BaselineError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
    new, suppressed = apply_baseline(findings, sups)

    for err in errors:
        print(f"parse error: {err}", file=sys.stderr)
    if not args.quiet:
        for f in new:
            print(f.render())
        unused = [s for s in sups if not s.used]
        for s in unused:
            print(f"warning: unused baseline suppression {s.rule} @ "
                  f"{s.file}" + (f" [{s.scope}]" if s.scope else "") +
                  " — remove it", file=sys.stderr)
    print(f"modelx-analysis: {len(new)} new finding(s), "
          f"{len(suppressed)} baseline-suppressed, "
          f"{len(findings)} total across {len(set(f.file for f in findings)) or 0} file(s)")
    return 1 if new else 0
