"""Human size formatting (counterpart of ``modelx_tpu/utils/units.py``):
decimal or binary units, at most 4 significant digits."""

from __future__ import annotations

_DECIMAL = ["B", "kB", "MB", "GB", "TB", "PB", "EB"]
_BINARY = ["B", "KiB", "MiB", "GiB", "TiB", "PiB", "EiB"]


def _human(size: float, base: float, units: list[str]) -> str:
    i = 0
    while size >= base and i < len(units) - 1:
        size /= base
        i += 1
    if size == int(size):
        return f"{int(size)}{units[i]}"
    return f"{size:.4g}{units[i]}"


def human_size(size: float) -> str:
    """Decimal (SI) size, e.g. 1000 -> '1kB'."""
    return _human(size, 1000.0, _DECIMAL)


def human_size_binary(size: float) -> str:
    """Binary size, e.g. 1024 -> '1KiB'."""
    return _human(size, 1024.0, _BINARY)
