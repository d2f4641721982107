"""BKW accuracy + performance driver — the main entry point.

Rebuild of ``maxwell_bkw_fftw.cpp`` / ``maxwell_bkw_cuda.cu``:
builds the BKW distribution for Maxwell molecules, evaluates the collision
operator over timed trials, and reports run statistics plus L1/L2/Linf errors
against the analytic ``df/dt`` in the reference's output format.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser, vhs_kwargs

    p = standard_parser(__doc__)
    p.add_argument("--steps", type=int, default=0,
                   help="RK4 relaxation steps (0 = single operator eval)")
    p.add_argument("--dt", type=float, default=0.125, help="RK4 step size")
    p.add_argument("--t0", type=float, default=5.5,
                   help="BKW start time for relaxation mode")
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default, resolve_impl
    enable_cache_default()

    import jax.numpy as jnp

    import boltzfft as bz

    dtype = args.dtype or default_dtype()
    print("\nRun arguments:")
    print(f"Nv = {args.Nv}")
    print(f"Ns = {args.Ns}")
    print(f"trials = {args.trials}")
    print(f"dtype = {dtype}, impl = {args.impl}")

    if args.impl == "ds":
        return _run_ds(args)

    # Maxwell molecules by default (maxwell_bkw_fftw.cpp:54-55); t = 6.5 (:74)
    cfg = bz.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns, impl=resolve_impl(args.impl),
        dtype=dtype, node_chunk=args.node_chunk, n_radial=args.n_radial,
        **vhs_kwargs(args),
    )
    if args.gamma != 0.0:
        print("note: BKW error report is only meaningful for Maxwell molecules (gamma=0)")
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f_bkw = np.asarray(bz.bkw_f(rsq, 6.5))
    q_bkw = np.asarray(bz.bkw_dfdt(rsq, 6.5))

    t0 = time.perf_counter()
    collide, pre = bz.make_collision_operator(cfg)

    if args.steps > 0:
        # RK4 relaxation: integrate f_bkw(t0) forward and compare with the
        # analytic BKW solution at t0 + steps*dt, with on-device moments.
        t_end = args.t0 + args.steps * args.dt
        f0 = jnp.asarray(np.asarray(bz.bkw_f(rsq, args.t0)), cfg.real_dtype)
        if cfg.is_isotropic:
            v = jnp.asarray(g.v, cfg.real_dtype)
        else:
            v = tuple(jnp.asarray(a, cfg.real_dtype) for a in (g.vx, g.vy, g.vz))
        run = bz.make_relaxation(
            collide, pre, dt=args.dt, n_steps=args.steps, method="rk4",
            record=lambda x: bz.moments(x, v, cell_volume=g.cell_volume),
        )
        traj = run(f0)
        mass = np.asarray(traj.recorded.mass)
        print(f"Relaxation: {args.steps} RK4 steps of dt={args.dt} "
              f"(t {args.t0} -> {t_end}), compile+run {time.perf_counter()-t0:.3g}s")
        print(f"mass drift: {abs(mass - mass[0]).max():.3e}, "
              f"energy drift: {abs(np.asarray(traj.recorded.energy) - np.asarray(traj.recorded.energy)[0]).max():.3e}")
        f_exact = jnp.asarray(bz.bkw_f(rsq, t_end), cfg.real_dtype)
        err = bz.error_norms_device(traj.f, f_exact, cell_volume=g.cell_volume)
        print("Relaxation errors vs analytic BKW f(t_end):")
        print(f"L1 error: {err['L1']:.6g}")
        print(f"L2 error: {err['L2']:.6g}")
        print(f"Linf error: {err['Linf']:.6g}\n")
        return 0

    f_dev = jnp.asarray(f_bkw, cfg.real_dtype)
    q = collide(f_dev, pre)  # compile + first eval
    float(jnp.sum(q))  # scalar device-to-host read = synchronization
    init_time = time.perf_counter() - t0
    print(f"Initialization time (s): {init_time:.6g} seconds")

    times = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        q = collide(f_dev, pre)
        float(jnp.sum(q))
        times.append(time.perf_counter() - t0)
    print(bz.RunStats.from_times(times).summary(f"boltzfft/{args.impl}"))

    # norms reduced on device: only three scalars come back to the host
    err = bz.error_norms_device(
        q, jnp.asarray(q_bkw, cfg.real_dtype), cell_volume=g.cell_volume
    )
    print("Approximation errors:")
    print(f"L1 error: {err['L1']:.6g}")
    print(f"L2 error: {err['L2']:.6g}")
    print(f"Linf error: {err['Linf']:.6g}\n")
    return 0


def _run_ds(args):
    """Compensated double-single evaluation: f64-class BKW errors from float32
    pairs (``boltzfft.ds_operator``).  The input is split exactly from
    host float64 and the error norms are reduced on device in ds arithmetic."""
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import ds
    from boltzfft.cli import vhs_kwargs

    cfg = bz.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns, impl="c2c",
        dtype="float32", n_radial=args.n_radial, **vhs_kwargs(args),
    )
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f_ds = ds.from_f64(np.asarray(bz.bkw_f(rsq, 6.5), np.float64))
    q_ex = ds.from_f64(np.asarray(bz.bkw_dfdt(rsq, 6.5), np.float64))
    dv3 = g.cell_volume

    t0 = time.perf_counter()
    collide_fn, pre = bz.make_ds_collision_operator(
        cfg, jit=False, contract=args.ds_contract, oz_cmax=args.oz_cmax,
        g_stream=args.g_stream, group_batch=args.group_batch,
        oz_merge=None if args.oz_merge is None else args.oz_merge == "on",
        g1_reversal=args.g1_reversal,
    )

    if args.steps > 0:
        # ds relaxation: the f32-pair state tracks an f64 integration
        t_end = args.t0 + args.steps * args.dt
        f0 = ds.from_f64(np.asarray(bz.bkw_f(rsq, args.t0), np.float64))
        run = bz.make_relaxation(
            collide_fn, pre, dt=args.dt, n_steps=args.steps, method="rk4"
        )
        traj = run(f0)
        f_exact = ds.from_f64(np.asarray(bz.bkw_f(rsq, t_end), np.float64))
        d = ds.sub(traj.f, f_exact)
        ad = jnp.abs(d.hi + d.lo)
        print(f"Relaxation (ds): {args.steps} RK4 steps of dt={args.dt} "
              f"(t {args.t0} -> {t_end}), compile+run "
              f"{time.perf_counter() - t0:.3g}s")
        print("Relaxation errors vs analytic BKW f(t_end):")
        print(f"L1 error: {float(dv3 * jnp.sum(ad)):.6g}")
        print(f"L2 error: {float(jnp.sqrt(dv3 * jnp.sum(ad * ad))):.6g}")
        print(f"Linf error: {float(jnp.max(ad)):.6g}\n")
        return 0

    @jax.jit
    def run(f, pre, qex):
        q = collide_fn(f, pre)
        d = ds.sub(q, qex)
        ad = jnp.abs(d.hi + d.lo)
        return dv3 * jnp.sum(ad), jnp.sqrt(dv3 * jnp.sum(ad * ad)), jnp.max(ad)

    l1, l2, linf = [float(x) for x in run(f_ds, pre, q_ex)]
    print(f"Initialization time (s): {time.perf_counter() - t0:.6g} seconds")

    times = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        out = run(f_ds, pre, q_ex)
        _ = [float(x) for x in out]
        times.append(time.perf_counter() - t0)
    print(bz.RunStats.from_times(times).summary("boltzfft/ds"))

    print("Approximation errors:")
    print(f"L1 error: {l1:.6g}")
    print(f"L2 error: {l2:.6g}")
    print(f"Linf error: {linf:.6g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
