"""Where the program runs: device report, GPU check and compile cache.

The CLI's ``main``, ``bench.py`` and ``chip_smoke.py`` call
:func:`enable_compile_cache` before their first computation and name the
device they ran on with :func:`jax_device`. Measurement paths
(``bench.py``, ``chip_smoke.py``) call :func:`require_gpu`: a JAX install
without its CUDA plugin falls back to the CPU silently, and a timing taken
there must not pass for a GPU number.
"""
from __future__ import annotations

import os
import pathlib
import subprocess

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")


def cache_dir(environ=None) -> str:
    """The persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed ``<repo>/.jax_cache`` (the path is part of the
    cache key, so it never depends on a temp name, a pid or a time)."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or str(REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def jax_device() -> dict:
    """The device JAX computes on, as JAX reports it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`jax_device`, or RuntimeError when JAX found no GPU."""
    dev = jax_device()
    if dev["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX runs on {dev['platform']!r} "
            f"({dev['kind']}). Measurement paths need JAX's CUDA plugin "
            "and a visible NVIDIA GPU.")
    return dev


def parse_smi_line(line: str) -> dict:
    """``'NVIDIA H100 80GB HBM3, 700.00 W'`` -> name and power limit."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return {"name": name.strip(), "power_limit": limit.strip()}


def card_lines(timeout: float = 30.0) -> list[str]:
    """One ``name, power.limit`` line per card, from ``nvidia-smi`` run
    as a child process (it does not import JAX). Empty when there is no
    ``nvidia-smi``."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=timeout, check=True).stdout
    except FileNotFoundError:
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
