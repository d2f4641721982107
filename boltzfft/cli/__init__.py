"""Command-line drivers (the reference's L4 layer, argparse instead of TCLAP).

Run as modules, e.g.:

    python -m boltzfft.cli.maxwell_bkw --Nv 32 --Ns 12 --trials 10
    python -m boltzfft.cli.fft_benchmark --Nv 32 --Ns 12
    python -m boltzfft.cli.loop_benchmark --Nv 32 --Ns 12
    python -m boltzfft.cli.ensemble_bkw --ensemble 256 --steps 10

Flags mirror the reference drivers (``maxwell_bkw_fftw.cpp:29-44``).
"""

from __future__ import annotations

import argparse


def standard_parser(description: str) -> argparse.ArgumentParser:
    """Shared flags: --Nv, --Ns, -t/--trials (+ dtype/impl and the pipeline
    options this package adds)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--Nv", type=int, default=32, help="velocity grid points per axis")
    p.add_argument("--Nvy", type=int, default=None,
                   help="y-axis grid points (default: Nv; reference ctor parity)")
    p.add_argument("--Nvz", type=int, default=None,
                   help="z-axis grid points (default: Nv)")
    p.add_argument("--Ns", type=int, default=12, help="spherical design size")
    p.add_argument("-t", "--trials", type=int, default=1, help="timing trials")
    p.add_argument(
        "--dtype", choices=["float32", "float64"], default=None,
        help="compute dtype (default: float64 if the backend supports it)",
    )
    p.add_argument(
        "--impl", choices=["auto", "rfft", "c2c", "dft", "ds"],
        default="rfft",
        help="pipeline: rfft (real transforms, default), c2c (reference-"
             "faithful), dft (DFT matrix products), ds (compensated "
             "double-single: f64-class digits from float32 pairs); auto = "
             "the backend's choice (boltzfft.device.pipeline_choice)",
    )
    p.add_argument(
        "--ds-contract", choices=["vpu", "oz"], default=None,
        help="ds transform engine (--impl ds only): vpu = compensated "
             "rank-1 updates (bit-exact reference), oz = Ozaki-scheme "
             "sliced bf16 matrix products; default = the backend's choice",
    )
    p.add_argument(
        "--oz-cmax", type=int, default=None,
        help="Ozaki slice-pair retention for the ds oz engine (default 6 = "
             "all reference digits; lower drops the last digits, 7 = max "
             "retention)",
    )
    p.add_argument(
        "--g-stream", choices=["full", "half"], default="full",
        help="ds oz inverse-stream formulation: full = direct complex "
             "streams, half = exact half-spectrum Nyquist-block "
             "decomposition (same digits, less transform work; even grids)",
    )
    p.add_argument(
        "--group-batch", type=int, default=1,
        help="ds half path: radial groups per batch of contractions (must "
             "divide the radial group count)",
    )
    p.add_argument(
        "--oz-merge", choices=["on", "off"], default=None,
        help="ds oz engine: K-merged complex contraction (half the "
             "compensated-fold work; exactness gated per stage by "
             "oz.merge_ok).  Default on",
    )
    p.add_argument(
        "--g1-reversal", action="store_true",
        help="ds half path, OPT-IN: derive stream 1 from stream 2 by the "
             "physical velocity reversal — EXACT ONLY for centrally "
             "symmetric f(v) = f(-v) (e.g. the BKW/Maxwellian relaxation "
             "states this driver evaluates); halves the dominant per-node "
             "transform work",
    )
    p.add_argument(
        "--node-chunk", type=int, default=None,
        help="quadrature nodes per scan chunk (memory/speed tradeoff)",
    )
    p.add_argument(
        "--n-radial", type=int, default=None,
        help="Gauss-Legendre radial points (default: Nv, as in the reference)",
    )
    # VHS kernel parameters (defaults: Maxwell molecules, maxwell_bkw_fftw.cpp:54-55)
    p.add_argument("--gamma", type=float, default=0.0,
                   help="VHS velocity exponent (0=Maxwell, 1=hard spheres)")
    p.add_argument("--b-gamma", type=float, default=None,
                   help="VHS kernel coefficient (default 1/(4*pi))")
    p.add_argument(
        "--no-antipodal", dest="antipodal", action="store_false",
        help="evaluate all Ns spherical nodes like the reference instead of "
             "the exact antipodal-pair reduction (Ns/2 nodes, 2x weights)",
    )
    return p


def vhs_kwargs(args) -> dict:
    """CollisionConfig kwargs for the VHS kernel flags."""
    import math

    kw = {"gamma": args.gamma, "antipodal": getattr(args, "antipodal", True)}
    if args.b_gamma is not None:
        kw["b_gamma"] = args.b_gamma
    else:
        kw["b_gamma"] = 1.0 / (4.0 * math.pi)
    return kw


def resolve_impl(impl: str) -> str:
    """Resolve ``--impl auto`` to the backend's staged pipeline
    (:func:`boltzfft.device.pipeline_choice`)."""
    if impl != "auto":
        return impl
    from boltzfft.device import pipeline_choice

    return pipeline_choice().impl


def enable_cache_default() -> None:
    """Turn on the persistent XLA compilation cache for CLI runs (the FFTW
    wisdom-file analog, :func:`boltzfft.cache.enable_compilation_cache`): a
    driver rerun at the same config skips the compile.  Disabled with
    ``BOLTZFFT_NO_CACHE=1``."""
    import os

    if os.environ.get("BOLTZFFT_NO_CACHE") == "1":
        return
    from boltzfft import enable_compilation_cache

    enable_compilation_cache()


def default_dtype() -> str:
    """float64 when the active backend supports it, else float32."""
    import jax
    import jax.numpy as jnp

    if not jax.config.jax_enable_x64:
        return "float32"
    try:
        jnp.zeros((), jnp.float64)
        return "float64"
    except Exception:
        return "float32"
