"""Where JAX keeps the decoder's compiled programs between processes.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here changes it; nor is a directory that the caller already gave
`jax.config` changed.  Otherwise the persistent cache goes to
`.jax_cache/` at the root of the checkout: a fixed directory, so the
next process finds what this one compiled.
"""
import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory.
    Call before the first compile: JAX fixes the cache at that point."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax
    if jax.config.jax_compilation_cache_dir:
        return jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
