"""Run-timing statistics and benchmark harness.

Equivalent of the reference's ``Utilities/statistics.hpp`` (min/max/mean/stdev
over trial timings + ``print_stats_summary``, ``statistics.hpp:11-63``) plus a
JAX-aware timer that uses ``block_until_ready`` to bracket device work — the
analog of the reference's ``omp_get_wtime`` brackets
(``maxwell_bkw_fftw.cpp:133-140``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class RunStats:
    mean: float
    minimum: float
    maximum: float
    stdev: float
    n: int

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "RunStats":
        arr = np.asarray(times, dtype=np.float64)
        try:  # native single-pass Welford accumulation (long double)
            from boltzfft import _native

            mean, mn, mx, stdev = _native.running_stats(arr)
            return cls(mean=mean, minimum=mn, maximum=mx, stdev=stdev, n=int(arr.size))
        except ImportError:
            pass
        # Sample stdev (ddof=1) like the reference (statistics.hpp:40-50);
        # 0 for a single trial.
        stdev = float(arr.std(ddof=1)) if arr.size > 1 else 0.0
        return cls(
            mean=float(arr.mean()),
            minimum=float(arr.min()),
            maximum=float(arr.max()),
            stdev=stdev,
            n=int(arr.size),
        )

    def summary(self, label: str) -> str:
        """Scientific-notation summary, format-compatible with
        ``print_stats_summary`` (statistics.hpp:53-63)."""
        return (
            f"Statistics for {label} (s):\n"
            f"mean: {self.mean:.4e}\n"
            f"min: {self.minimum:.4e}\n"
            f"max: {self.maximum:.4e}\n"
            f"stdev: {self.stdev:.4e}\n"
        )


def time_fn(
    fn: Callable,
    *args,
    trials: int = 10,
    warmup: int = 2,
    **kwargs,
) -> tuple[RunStats, object]:
    """Time ``fn(*args)`` over ``trials`` runs with device synchronization.

    Runs ``warmup`` untimed calls first (compilation + cache warm), then times
    each call with ``jax.block_until_ready`` on the result.  Returns the stats
    and the last result.
    """
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return RunStats.from_times(times), out


class trace:
    """Context manager around ``jax.profiler`` — the observability analog of
    the reference's wall-clock brackets (``maxwell_bkw_fftw.cpp:114-140``),
    but producing a full device trace viewable in TensorBoard/Perfetto.

    Usage::

        with bz.trace("/tmp/boltz-trace"):
            collide(f, pre)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        jax.profiler.stop_trace()
        return False


def _vol(dv, cell_volume) -> float:
    if (dv is None) == (cell_volume is None):
        raise ValueError("pass exactly one of dv / cell_volume")
    return float(cell_volume) if cell_volume is not None else float(dv) ** 3


def error_norms(
    q: np.ndarray, q_exact: np.ndarray, dv: float = None, *,
    cell_volume: float = None,
) -> dict[str, float]:
    """L1/L2/Linf error norms with the reference's scaling conventions.

    L1 = dv^3 * sum|diff|; L2 = sqrt(dv^3 * sum diff^2); Linf = max|diff|
    (``maxwell_bkw_fftw.cpp:150-161`` — note the L2 convention multiplies the
    squared sum by dv^3 *before* the square root; reproduced for parity).
    Anisotropic grids pass ``cell_volume=dx*dy*dz`` instead of ``dv``.
    """
    vol = _vol(dv, cell_volume)
    diff = np.abs(np.asarray(q, dtype=np.float64) - np.asarray(q_exact, dtype=np.float64))
    return {
        "L1": float(vol * diff.sum()),
        "L2": float(np.sqrt(vol * (diff**2).sum())),
        "Linf": float(diff.max()),
    }


def error_norms_device(
    q, q_exact, dv: float = None, *, cell_volume: float = None
) -> dict[str, float]:
    """Same norms reduced on the device; only three scalars cross to the host.

    Use instead of :func:`error_norms` to keep large arrays on the device.
    """
    import jax.numpy as jnp

    vol = _vol(dv, cell_volume)
    q = jnp.asarray(q)
    diff = jnp.abs(q - jnp.asarray(q_exact, q.dtype))
    return {
        "L1": float(vol * jnp.sum(diff)),
        "L2": float(jnp.sqrt(vol * jnp.sum(diff**2))),
        "Linf": float(jnp.max(diff)),
    }
