"""Repo-alias manager over ~/.modelx/repos.json (counterpart of
``modelx_tpu/client/repo.py``): the same file format
(``{"repos": [{"name","url","token"}]}``), lookup by name or URL, and the
add, list and remove behind ``modelx-torch repo`` and ``login``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from urllib.parse import urlparse


@dataclasses.dataclass
class RepoDetails:
    name: str = ""
    url: str = ""
    token: str = ""

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v}


class RepoManager:
    def __init__(self, path: str) -> None:
        self.path = path

    def _load(self) -> list[RepoDetails]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return []
        return [
            RepoDetails(name=r.get("name", ""), url=r.get("url", ""), token=r.get("token", ""))
            for r in data.get("repos", [])
        ]

    def _save(self, repos: list[RepoDetails]) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"repos": [r.to_json() for r in repos]}, f, indent=2)

    def list(self) -> list[RepoDetails]:
        return self._load()

    def get(self, name_or_url: str) -> RepoDetails | None:
        """Lookup by alias name or by URL."""
        for r in self._load():
            if r.name == name_or_url or r.url == name_or_url:
                return r
        return None

    def set(self, item: RepoDetails) -> None:
        """Add, or update by name."""
        u = urlparse(item.url)
        if u.scheme not in ("http", "https") or not u.netloc:
            raise ValueError(f"invalid url: {item.url}")
        repos = [r for r in self._load() if r.name != item.name]
        repos.append(item)
        self._save(repos)

    def remove(self, name: str) -> bool:
        repos = self._load()
        kept = [r for r in repos if r.name != name]
        self._save(kept)
        return len(kept) < len(repos)


def default_repo_manager() -> RepoManager:
    return RepoManager(os.path.join(os.path.expanduser("~"), ".modelx", "repos.json"))
