"""The device the program runs on, and where its compiled programs are kept.

The device paths run on one NVIDIA GPU; `gpu_available` is the one test of
that. JAX's persistent compilation cache is the directory that
JAX_COMPILATION_CACHE_DIR names when it is set (JAX reads it itself, and
nothing here overrides it); otherwise it is the fixed directory
`<checkout>/.jax_cache`, set at the first device-path use.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)

_CACHE_SET = False


def gpu_available() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"


def enable_compilation_cache() -> None:
    global _CACHE_SET
    if _CACHE_SET:
        return
    _CACHE_SET = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
