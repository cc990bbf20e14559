"""Repo-alias manager over ~/.modelx/repos.json (counterpart of
``modelx_tpu/client/repo.py``): the same file format
(``{"repos": [{"name","url","token"}]}``), lookup by name or URL; the
``modelx repo`` commands that write it come with the control plane.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class RepoDetails:
    name: str = ""
    url: str = ""
    token: str = ""


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

    def get(self, name_or_url: str) -> RepoDetails | None:
        """Lookup by alias name or by URL."""
        for r in self._load():
            if r.name == name_or_url or r.url == name_or_url:
                return r
        return None


def default_repo_manager() -> RepoManager:
    return RepoManager(os.path.join(os.path.expanduser("~"), ".modelx", "repos.json"))
