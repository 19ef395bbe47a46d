"""Where the package keeps what it builds at run time.

Every cache (compiled XLA programs, steering tables, the native ingest
library, demo detector weights) lives under one fixed directory inside
the checkout, ``<checkout>/.cache/`` (listed in ``.gitignore``), so a run
reads and writes nothing outside its own tree and a fixed path lets a
persistent cache hit across processes.
"""

from __future__ import annotations

import os

CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def cache_dir(name: str) -> str:
    """``<checkout>/.cache/<name>`` (created on demand)."""
    path = os.path.join(CACHE_ROOT, name)
    os.makedirs(path, exist_ok=True)
    return path
