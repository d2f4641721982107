"""Known-answer self-check — lightweight failure detection.

The reference's failure handling is exit-on-error macros
(``CUDABoltzmannOperator.hpp:20-38``); a production deployment instead
wants a cheap runtime probe that the device computes *correct* results (not
just that kernels launch): evaluate the collision operator on a small BKW
problem and compare against the analytic oracle ``bkw_dfdt``
(``maxwell_bkw_fftw.cpp:94-96``), exactly like the reference drivers validate
themselves — but as a callable probe with a pass/fail verdict.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

# Calibrated relative-Linf thresholds (max|Q - Q_bkw| / max|Q_bkw|) for the
# probe config nv=24, ns=6, n_radial=12, t=6.5.  Measured method error there
# is 4.12e-2 (f64, CPU); f32 roundoff sits orders of magnitude below it, so
# one threshold (3x measured) covers every backend/impl.  A wrong-but-bounded Q — e.g. a mis-scaled loss
# term — lands at O(1) relative error and fails decisively (tested).
_REL_TOL = 0.12
_PROBE_TIME = 6.5


def selfcheck(
    nv: int = 24,
    ns: int = 6,
    n_radial: Optional[int] = None,
    dtype: Optional[str] = None,
    impl: Optional[str] = None,
    rel_tol: float = _REL_TOL,
    pre_transform: Optional[Callable] = None,
    cfg_kwargs: Optional[dict] = None,
    compare_impl: Optional[str] = None,
) -> dict:
    """Run a small end-to-end collision eval and compare against the analytic
    BKW oracle.

    Returns a dict with ``ok`` (bool), the achieved relative Linf deviation,
    timing, and backend info.  Cheap enough to run at job start or after
    suspected device faults.  ``impl`` defaults to the backend's pipeline
    (:func:`boltzfft.device.pipeline_choice`).  ``pre_transform`` is a
    fault-injection hook: it receives the
    ``Precomp`` pytree before the eval (used by tests to verify that corrupted
    weights are detected).  ``cfg_kwargs`` passes extra
    :class:`~boltzfft.CollisionConfig` fields (e.g. ``dft_precision``,
    ``nvy``/``nvz``) so knob combinations can be probed on hardware.

    ``compare_impl`` switches the oracle: instead of the analytic BKW
    derivative (whose method error depends on the grid and is only
    calibrated for the default probe config), compare against a second
    pipeline (e.g. ``"rfft"``) evaluated on the SAME device.  That is the
    right probe for configs with no calibrated analytic bound — anisotropic
    grids, VHS ``gamma != 0`` (BKW is Maxwell-molecules-only,
    ``maxwell_bkw_fftw.cpp:74-96``) — since implementation breakage lands at
    O(1) while two healthy pipelines agree to f32 class.
    Pass a matching ``rel_tol`` (default is the analytic-oracle one).
    """
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    if dtype is None:
        dtype = "float64" if jax.config.jax_enable_x64 else "float32"
    if impl is None:
        impl = bz.pipeline_choice().impl

    cfg = bz.CollisionConfig(
        nv=nv, ns=ns, n_radial=n_radial if n_radial is not None else nv // 2,
        dtype=dtype, impl=impl, **(cfg_kwargs or {}),
    )
    collide, pre = bz.make_collision_operator(cfg)
    if pre_transform is not None:
        pre = pre_transform(pre)
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f = jnp.asarray(np.asarray(bz.bkw_f(rsq, _PROBE_TIME)), cfg.real_dtype)
    if compare_impl is None:
        q_exact = jnp.asarray(
            np.asarray(bz.bkw_dfdt(rsq, _PROBE_TIME)), cfg.real_dtype
        )

    t0 = time.perf_counter()
    q = collide(f, pre)
    if compare_impl is not None:
        import dataclasses

        cfg_ref = dataclasses.replace(cfg, impl=compare_impl)
        collide_ref, pre_ref = bz.make_collision_operator(cfg_ref)
        q_exact = collide_ref(f, pre_ref)
    # reduce on device; fetch only scalars
    q_max = float(jnp.max(jnp.abs(q_exact)))
    rel_linf = float(jnp.max(jnp.abs(q - q_exact))) / q_max
    q_mass = float(jnp.sum(q)) * g.cell_volume
    finite = bool(jnp.all(jnp.isfinite(q)))
    elapsed = time.perf_counter() - t0

    ok = finite and rel_linf < rel_tol
    return {
        "ok": ok,
        "finite": finite,
        "rel_linf": rel_linf,
        "rel_tol": rel_tol,
        "q_mass": q_mass,
        "elapsed_s": elapsed,
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "config": {"nv": nv, "ns": ns, "dtype": dtype, "impl": impl},
    }


def selfcheck_ds(
    nv: int = 16,
    ns: int = 6,
    n_radial: Optional[int] = None,
    rel_tol: float = 1e-11,
    cfg_kwargs: Optional[dict] = None,
    symmetrize: bool = False,
    compiler_options: Optional[dict] = None,
    **collide_kwargs,
) -> dict:
    """Cross-engine known-answer probe for the compensated (ds) pipeline.

    Evaluates ``collide_ds`` with the Ozaki engine (``contract="oz"``, plus
    any knob combination passed through ``collide_kwargs``: ``g_stream``,
    ``herm_downstream``, ``group_batch``, ``oz_merge``, ``oz_cmax``) against
    the bit-exact ``"vpu"`` reference engine ON THE SAME DEVICE, and reports
    the relative Linf deviation.  The bound is the ds noise floor (~2^-49
    relative; default tol 1e-11 with margin): the oz engine is exact only
    if the device accumulates its bf16 slice products in float32 without
    rounding — a device whose matrix unit breaks that lands orders of
    magnitude above it.

    Input is Nyquist-rich positive noise (adversarial for the half-spectrum
    path's exactness claims), fixed seed for reproducibility.
    ``symmetrize`` makes it centrally symmetric (``f(v) = f(-v)``, the pure
    index flip on the cell-centered grid) — required for probing the
    even-input-only ``g1_reversal`` knob.  ``compiler_options`` are XLA
    options for the probe's one compile (e.g. ``{"xla_gpu_autotune_level":
    0}``: the oz engine is thousands of small matrix products, and autotuning
    each one dominates a GPU compile).
    """
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import ds
    from boltzfft.ds_operator import build_ds_precomp, collide_ds

    cfg = bz.CollisionConfig(
        nv=nv, ns=ns, n_radial=n_radial if n_radial is not None else nv // 2,
        dtype="float32", impl="c2c", **(cfg_kwargs or {}),
    )
    pre = build_ds_precomp(cfg)
    rng = np.random.default_rng(12345)
    fm = np.abs(rng.standard_normal(cfg.grid_shape)) + 0.1
    if symmetrize:
        fm = 0.5 * (fm + fm[::-1, ::-1, ::-1])
    f = ds.from_f64(fm)

    t0 = time.perf_counter()

    def both(p, x):
        q_oz = collide_ds(cfg, p, x, contract="oz", **collide_kwargs)
        q_ref = collide_ds(cfg, p, x, contract="vpu")
        dev = q_oz.hi - q_ref.hi + (q_oz.lo - q_ref.lo)
        return (
            jnp.max(jnp.abs(dev)),
            jnp.max(jnp.abs(q_ref.hi)),
            jnp.all(jnp.isfinite(q_oz.hi) & jnp.isfinite(q_oz.lo)),
        )

    compiled = jax.jit(both).lower(pre, f).compile(compiler_options)
    dev, scale, finite = compiled(pre, f)
    rel = float(dev) / float(scale)
    finite = bool(finite)
    elapsed = time.perf_counter() - t0
    ok = finite and rel < rel_tol
    return {
        "ok": ok,
        "finite": finite,
        "rel_linf": rel,
        "rel_tol": rel_tol,
        "elapsed_s": elapsed,
        "backend": jax.default_backend(),
        "config": {"nv": nv, "ns": ns, **collide_kwargs},
    }
