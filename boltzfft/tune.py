"""Timing-probe autotuners for the pipelines' blocking parameters.

The analog of the reference's FFTW planner/wisdom machinery
(``FFTWBoltzmannOperator.cpp:60-68`` spends startup time measuring plans,
then caches the winner; ``fftw_benchmark.cpp:253-292`` does exhaustive
planning): each probe times a short chained run per candidate and memoizes
the winner in-process and optionally on disk (the wisdom-file analog).

* :func:`autotune` — the staged impls' ``node_chunk`` (scan-step count vs
  FFT batch width and device-memory working set).
* :func:`autotune_ds` — the compensated pipeline's ``sub_batch`` (nodes of a
  radial group in flight through the ds elementwise stages).

    cfg = bz.autotune(bz.CollisionConfig(nv=64, ns=12, impl="rfft",
                                         dtype="float32"))
    collide_fn, pre = bz.make_collision_operator(cfg)
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

from .weights import CollisionConfig

_MEMO: dict = {}


def _time_candidate(cfg: CollisionConfig, k: int, trials: int) -> float:
    """Best-of-``trials`` seconds per eval over ``k`` chained evals, timed
    around a host read of the result (which waits for the device)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import bkw as _bkw
    from .operator import collide
    from .weights import build_precomp

    pre = build_precomp(cfg)
    f0 = jnp.asarray(
        np.asarray(_bkw.bkw_f(cfg.velocity_grid.r_squared(), 6.5)),
        cfg.real_dtype,
    )

    @partial(jax.jit, static_argnums=2)
    def chain(f, p, steps):
        body = lambda i, x: x + 1e-3 * collide(cfg, p, x)
        return jax.lax.fori_loop(0, steps, body, f)

    out = chain(f0, pre, k)
    float(jnp.sum(out))  # compile + sync
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        out = chain(f0, pre, k)
        float(jnp.sum(out))
        best = min(best, time.perf_counter() - t0)
    return best / k


# ---------------------------------------------------------------------------
# staged (rfft/c2c/dft) node-chunk autotune
# ---------------------------------------------------------------------------


def _chunk_key(cfg: CollisionConfig) -> tuple:
    return (
        "chunk", cfg.impl, cfg.nv, cfg.nvy, cfg.nvz, cfg.ns, cfg.n_gl,
        cfg.dtype, cfg.antipodal,
    )


def _chunk_candidates(cfg: CollisionConfig) -> list:
    """Distinct node_chunk values worth probing: the memory-derived auto
    chunk plus halvings/doublings of it, normalized through cfg.chunk."""
    import dataclasses as dc

    auto = cfg.auto_chunk()
    b = cfg.n_nodes
    raw = {auto, max(1, auto // 2), max(1, auto // 4), min(b, 2 * auto), b}
    seen, cands = set(), []
    for c in sorted(raw):
        eff = dc.replace(cfg, node_chunk=c).chunk
        if eff in seen:
            continue
        seen.add(eff)
        cands.append(c)
    return cands


def autotune(
    cfg: CollisionConfig,
    candidates: Optional[Sequence] = None,
    k: int = 8,
    trials: int = 2,
    verbose: bool = False,
    cache_file: Optional[str] = None,
) -> CollisionConfig:
    """Measured-best ``node_chunk`` (see module docstring).

    Returns ``cfg`` updated with the winning chunk; memoized in-process
    and in ``cache_file`` when given.
    """
    key = _chunk_key(cfg)
    skey = "/".join(map(str, key))
    if key in _MEMO:
        return dataclasses.replace(cfg, node_chunk=_MEMO[key])
    if cache_file and Path(cache_file).exists():
        store = json.loads(Path(cache_file).read_text())
        if skey in store:
            _MEMO[key] = store[skey]
            return dataclasses.replace(cfg, node_chunk=store[skey])

    cands = list(candidates) if candidates is not None else _chunk_candidates(cfg)
    best, best_t = cfg.node_chunk, float("inf")
    for c in cands:
        trial_cfg = dataclasses.replace(cfg, node_chunk=c)
        try:
            t = _time_candidate(trial_cfg, k, trials)
        except Exception as e:  # candidate fails to compile/fit: skip it
            if verbose:
                print(f"autotune: node_chunk={c} failed: {type(e).__name__}: {e}")
            continue
        if verbose:
            print(f"autotune: node_chunk={c} -> {t:.4e} s/eval")
        if t < best_t:
            best, best_t = c, t
    _MEMO[key] = best
    if cache_file:
        p = Path(cache_file)
        store = json.loads(p.read_text()) if p.exists() else {}
        store[skey] = best
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(store, indent=1))
    return dataclasses.replace(cfg, node_chunk=best)


# ---------------------------------------------------------------------------
# ds sub_batch autotune
# ---------------------------------------------------------------------------


def _ds_key(cfg: CollisionConfig, contract: str) -> tuple:
    return (
        "ds", contract, cfg.nv, cfg.nvy, cfg.nvz, cfg.ns, cfg.n_gl,
        cfg.antipodal,
    )


def _time_ds_candidate(cfg: CollisionConfig, sub_batch: int, contract: str,
                       k: int, trials: int) -> float:
    import time as _time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import bkw as _bkw
    from . import ds
    from .ds_operator import build_ds_precomp, collide_ds

    pre = build_ds_precomp(cfg)
    f0 = ds.from_f64(
        np.asarray(_bkw.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
    )

    @jax.jit
    def chain(p, x):
        def body(i, s):
            q = collide_ds(cfg, p, s, sub_batch=sub_batch, contract=contract)
            return ds.add(s, ds.mul_f(q, 1e-3))

        out = jax.lax.fori_loop(0, k, body, x)
        return jnp.sum(out.hi)

    float(chain(pre, f0))  # compile + first run, synced via D2H
    best = float("inf")
    for _ in range(trials):
        t0 = _time.perf_counter()
        float(chain(pre, f0))
        best = min(best, _time.perf_counter() - t0)
    return best / k


def autotune_ds(
    cfg: CollisionConfig,
    contract: Optional[str] = None,
    candidates: Optional[Sequence[int]] = None,
    k: int = 2,
    trials: int = 2,
    verbose: bool = False,
    cache_file: Optional[str] = None,
) -> int:
    """Measured-best ``sub_batch`` for the compensated (ds) pipeline.

    Pass the result to :func:`boltzfft.make_ds_collision_operator`.  The
    candidate set covers divisors-ish of the per-radial-group node count
    (``cfg.ns_eff``); winners are memoized like the other autotuners.
    """
    from .device import pipeline_choice

    engine = contract or pipeline_choice().ds_contract
    key = _ds_key(cfg, engine)
    skey = "/".join(map(str, key))
    if key in _MEMO:
        return _MEMO[key]
    if cache_file and Path(cache_file).exists():
        store = json.loads(Path(cache_file).read_text())
        if skey in store:
            _MEMO[key] = store[skey]
            return store[skey]

    ns = cfg.ns_eff
    if candidates is None:
        candidates = sorted({c for c in (1, 2, 3, 4, 6, 8, ns) if c <= ns})
    best, best_t = min(4, ns), float("inf")
    for sb in candidates:
        try:
            t = _time_ds_candidate(cfg, sb, engine, k, trials)
        except Exception as e:
            if verbose:
                print(f"autotune_ds: sub_batch={sb} failed: "
                      f"{type(e).__name__}: {e}")
            continue
        if verbose:
            print(f"autotune_ds: sub_batch={sb} -> {t:.4e} s/eval")
        if t < best_t:
            best, best_t = sb, t
    _MEMO[key] = best
    if cache_file:
        p = Path(cache_file)
        store = json.loads(p.read_text()) if p.exists() else {}
        store[skey] = best
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(store, indent=1))
    return best
