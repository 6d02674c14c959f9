"""Compile setup: where the persistent compilation cache lives, and how
many host cores XLA:GPU compiles with.

Every entry point (chip_smoke.py, bench.py, __graft_entry__.py, the test
bootstrap) calls `setup_compile_cache` before its first compile.  When
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no directory is
set here; otherwise the cache goes to the fixed path `<checkout>/.jax_cache`
(a cache whose path moves never hits).
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(subdir: str | None = None) -> str:
    """The directory the cache uses: the environment's, else the fixed
    default (with `subdir` under it, for processes that must not share
    one directory)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(DEFAULT_DIR, subdir) if subdir else DEFAULT_DIR


def setup_compile_cache(subdir: str | None = None) -> str:
    """Enable the persistent cache; returns its directory."""
    import jax

    path = compile_cache_dir(subdir)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def parallel_gpu_compile() -> None:
    """Let XLA:GPU compile a program's kernels on every host core; it uses
    one by default, and the limb-arithmetic programs take minutes to
    compile cold.  Call before the first JAX device query."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "compilation_parallelism" not in flags:
        os.environ["XLA_FLAGS"] = " ".join([
            flags,
            "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
            f"--xla_gpu_force_compilation_parallelism={os.cpu_count()}",
        ]).strip()
