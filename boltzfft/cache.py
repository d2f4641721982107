"""Persistence: compilation cache and precompute serialization.

The reference's only persisted artifact is the FFTW wisdom file — a plan cache
imported/exported around plan creation (``FFTWBoltzmannOperator.cpp:60-68``,
``setWisdomFileName`` at ``FFTWBoltzmannOperator.hpp:39-41``).  The XLA-native
equivalents:

* ``enable_compilation_cache()``: turns on JAX's persistent compilation
  cache so jitted collision programs reload from disk across processes —
  wisdom, but for XLA executables.
* ``save_precomp``/``load_precomp``: serialize the quadrature/weight pytree so
  large setups (high-order designs, big beta2 tables) skip recomputation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .weights import CollisionConfig, Precomp

#: The checkout this package was imported from: the cache lives inside it.
CHECKOUT = Path(__file__).resolve().parent.parent


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.xla_cache``.

    The path is part of a cached program's key, so it is fixed: never a
    temporary or per-process directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".xla_cache"
    )


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (the wisdom-file analog)
    and return its directory (:func:`compilation_cache_dir`).

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing."""
    path = compilation_cache_dir()
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return path
    Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def save_precomp(path: str | Path, cfg: CollisionConfig, pre: Precomp) -> None:
    """Serialize (config, precomp) to an .npz archive."""
    arrays = {
        f"arr_{name}": np.asarray(v)
        for name, v in pre._asdict().items()
        if v is not None
    }
    np.savez_compressed(
        path, __config__=json.dumps(dataclasses.asdict(cfg)), **arrays
    )


def load_precomp(path: str | Path) -> tuple[CollisionConfig, Precomp]:
    """Load (config, precomp); arrays are placed with the config's dtypes."""
    with np.load(path, allow_pickle=False) as z:
        data = json.loads(str(z["__config__"]))
        # Archives written before the antipodal-pair reduction existed were
        # built from the full design; defaulting the missing key to False
        # keeps cfg.ns_eff consistent with the stored node tables (the new
        # default True would silently mis-group the radial hoisting).
        data.setdefault("antipodal", False)
        # Archives from versions with since-removed config fields: drop them.
        known = {f.name for f in dataclasses.fields(CollisionConfig)}
        cfg = CollisionConfig(**{k: v for k, v in data.items() if k in known})
        fields = {}
        for name in Precomp._fields:
            key = f"arr_{name}"
            fields[name] = jnp.asarray(z[key]) if key in z.files else None
    return cfg, Precomp(**fields)
