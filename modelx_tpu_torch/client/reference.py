"""Model reference parsing: ``repo-alias/project/name@version`` or full URL
(counterpart of ``modelx_tpu/client/reference.py``): repo-alias resolution
via ~/.modelx/repos.json, the MODELX_AUTH env override, ``?token=``, bare
names defaulting into the ``library/`` project, and ``modelx://`` URIs.
"""

from __future__ import annotations

import dataclasses
import os
from urllib.parse import parse_qs, urlparse

from modelx_tpu_torch.client.repo import RepoManager, default_repo_manager

MODELX_AUTH_ENV = "MODELX_AUTH"


@dataclasses.dataclass
class Reference:
    registry: str = ""
    repository: str = ""
    version: str = ""
    authorization: str = ""

    def __str__(self) -> str:
        base = f"{self.registry}/{self.repository}"
        return f"{base}@{self.version}" if self.version else base

    def client(self, quiet: bool = False):
        from modelx_tpu_torch.client.client import Client

        return Client(self.registry, self.authorization, quiet=quiet)


def parse_reference(raw: str, repo_manager: RepoManager | None = None) -> Reference:
    """reference.go:33-86."""
    auth = os.environ.get(MODELX_AUTH_ENV, "")
    if raw.startswith("modelx://"):
        raw = "https://" + raw[len("modelx://") :]
    if "://" not in raw:
        # alias form: "<alias>/<repository...>[@version]"
        mgr = repo_manager or default_repo_manager()
        alias, _, rest = raw.partition("/")
        details = mgr.get(alias)
        if details is None:
            raise ValueError(f"unknown repo alias: {alias!r} (try `modelx repo add`)")
        if not auth and details.token:
            auth = "Bearer " + details.token
        raw = details.url + ("/" + rest if rest else "")

    if not raw.startswith(("http://", "https://")):
        raw = "https://" + raw
    u = urlparse(raw)
    if not u.netloc:
        raise ValueError("invalid reference: missing host")
    token = parse_qs(u.query).get("token", [""])[0]
    if token:
        auth = "Bearer " + token

    path, _, version = u.path.partition("@")
    repository = path.lstrip("/")
    if repository and "/" not in repository:
        repository = "library/" + repository  # reference.go:75-77

    return Reference(
        registry=f"{u.scheme}://{u.netloc}",
        repository=repository,
        version=version,
        authorization=auth,
    )
