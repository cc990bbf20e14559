"""Version info (counterpart of ``modelx_tpu/version.py``): the package
version, with the git commit and its date resolved lazily when git is in
reach, in the JAX package's ``version=... commit=... date=...`` shape.
"""

from __future__ import annotations

import dataclasses
import subprocess

__version__ = "0.1.0"


@dataclasses.dataclass(frozen=True)
class VersionInfo:
    version: str
    git_commit: str
    build_date: str

    def __str__(self) -> str:
        return f"version={self.version} commit={self.git_commit} date={self.build_date}"


def _git(*args: str) -> str:
    try:
        out = subprocess.run(
            ["git", *args], capture_output=True, text=True, timeout=2, check=False
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except OSError:
        return ""


def get() -> VersionInfo:
    commit = _git("rev-parse", "--short", "HEAD") or "unknown"
    date = _git("log", "-1", "--format=%cI") or "unknown"
    return VersionInfo(version=__version__, git_commit=commit, build_date=date)
