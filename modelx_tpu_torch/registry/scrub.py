"""Startup reconciliation (counterpart of ``reconcile`` in
``modelx_tpu/registry/scrub.py``, index-only as the registry runs it at
boot): rebuild the global index from storage, so repositories whose commit
crashed before the index refresh reappear, then rebuild every repository's
index. The deep audit (re-hash, quarantine, dangling references) is the
scrub route's, which comes with the control-plane slice.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def reconcile(store) -> list[str]:
    """Rebuild the indexes from storage; returns the repositories rebuilt."""
    store.refresh_global_index()
    done = []
    for entry in store.get_global_index().manifests:
        try:
            if store._list_manifest_refs(entry.name):
                store.refresh_index(entry.name)
            done.append(entry.name)
        except Exception:
            logger.exception("reconcile: index rebuild of %s failed", entry.name)
    return done
