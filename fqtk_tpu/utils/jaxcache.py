"""Persistent JAX compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is honored as it stands and no
other directory is set.  Otherwise the cache lives at a fixed path in the
checkout, ``.jax_cache/`` (the path is part of what makes a later process
hit the cache).  Called from the CLI and the benchmark harness.

Deliberately does NOT import jax when it isn't loaded yet: the demux hot
path may never touch a device (host-matcher policies), and importing jax
costs ~1s of CLI cold start.  JAX reads the variable from the environment
at import time, so seeding ``os.environ`` configures any later import; an
already-imported jax is configured directly.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

#: the checkout's own cache directory (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = str(CACHE_DIR)
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    return cache_dir
