"""Space-inhomogeneous 2D×3V production demo: kinetic Taylor-Green vortex.

Solves ``df/dt + v·∇f = Q(f,f)/Kn`` on a periodic box with Strang splitting
(second-order MUSCL transport, per-cell spectral collisions).  The classic
incompressible Taylor-Green velocity field

    u(x, y) = U0 ( sin(2πx/L) cos(2πy/L), -cos(2πx/L) sin(2πy/L) )

initializes per-cell Maxwellians; the vortex decays through the coupled
kinetics (phase mixing + collisional viscosity).  The reference code has no
spatial transport at all (SURVEY.md §0); this driver is the scaled-up
production workload its collision kernel exists to feed, promoted from
``examples/taylor_green_2d3v.py`` with timing and a device-mesh mode.

Two execution modes:

* default — single device, cells vmapped over the flattened cell grid
  (the whole multi-cell step is one jitted program; the collision substep
  batches all cells into the spectral pipeline).
* ``--mesh MXxMY`` — explicit spatial domain decomposition over a device
  mesh (:func:`boltzfft.transport.make_sharded_step_2d`: shard_map,
  ppermute halo exchange, shard-local FFTs).  Run on several GPUs, or
  validate on a virtual CPU mesh with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.

    python -m boltzfft.cli.taylor_green_2d3v --cells 16 --Nv 16 --steps 20
    python -m boltzfft.cli.taylor_green_2d3v --mesh 4x2 --cells 16 --steps 20
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np


def taylor_green_f0(cfg, nc: int, *, u0: float, temperature: float,
                    length: float = 1.0):
    """Per-cell Maxwellian initial data with the Taylor-Green bulk field.

    Returns ``(nc, nc, Nvx, Nvy, Nvz)``.
    """
    import jax.numpy as jnp

    from boltzfft.bkw import maxwellian

    g = cfg.velocity_grid
    x = (np.arange(nc) + 0.5) * (length / nc)
    two_pi = 2.0 * np.pi / length
    ux = u0 * np.sin(two_pi * x)[:, None] * np.cos(two_pi * x)[None, :]
    uy = -u0 * np.cos(two_pi * x)[:, None] * np.sin(two_pi * x)[None, :]
    vsq = (
        (np.asarray(g.vx)[None, None, :, None, None]
         - ux[:, :, None, None, None]) ** 2
        + (np.asarray(g.vy)[None, None, None, :, None]
           - uy[:, :, None, None, None]) ** 2
        + np.asarray(g.vz)[None, None, None, None, :] ** 2
    )
    return jnp.asarray(
        np.asarray(maxwellian(vsq, density=1.0, temperature=temperature)),
        cfg.real_dtype,
    )


def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser, vhs_kwargs

    # Ns=12 default: anisotropic (bulk-shifted) states expose the k=0
    # gain/loss quadrature mismatch — the loss kernel's sigma integral is
    # exact while the gain's uses the Ns-point design, so mass(Q) carries
    # the design's quadrature error.  Measured on the two-beam state:
    # 6.9e-3 (Ns=6) -> 4.7e-5 (12) -> 9.6e-7 (32), Nv-independent.  The
    # homogeneous BKW drivers are isotropic and never see this.
    p = standard_parser(__doc__.splitlines()[0])
    p.set_defaults(Nv=16, Ns=12, impl="auto")
    p.add_argument("--cells", type=int, default=16,
                   help="spatial cells per axis (periodic square)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--x-length", type=float, default=1.0)
    p.add_argument("--knudsen", type=float, default=0.2)
    p.add_argument("--u0", type=float, default=0.8,
                   help="Taylor-Green bulk-velocity amplitude")
    p.add_argument("--temperature", type=float, default=3.0)
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: CFL-limited for the transport)")
    p.add_argument("--mesh", type=str, default=None, metavar="MXxMY",
                   help="spatial device decomposition, e.g. 4x2 (default: "
                        "single device, cells vmapped)")
    p.add_argument("--scheme", choices=["muscl", "upwind"], default="muscl")
    p.add_argument("--conserve", action="store_true",
                   help="project every Q onto vanishing invariant moments\n(bz.conservative): exact per-step mass/momentum/energy at a small\npointwise perturbation within the method-error class on resolved grids")
    p.add_argument("--mass-tol", type=float, default=1e-2,
                   help="relative mass-drift gate; the drift is the gain "
                        "quadrature's mass-moment error on anisotropic "
                        "states (vanishes with --Ns: 6.9e-3 at Ns=6, "
                        "4.7e-5 at 12, 9.6e-7 at 32), not an advection "
                        "error — the MUSCL transport conserves to roundoff")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H increase as "
                        "a fraction of the total dissipation |H_end - H_0| "
                        "(transport is H-neutral in the continuum; the MUSCL "
                        "limiter and the gain quadrature contribute "
                        "bounded-small non-monotone noise)")
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default, resolve_impl
    enable_cache_default()

    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import transport

    if args.impl == "ds":
        p.error("--impl ds is homogeneous-relaxation only; the 2D solver "
                "drives the staged pipelines (rfft/c2c/dft)")

    nc = args.cells
    mx = my = 1
    if args.mesh:
        try:
            mx, my = (int(s) for s in args.mesh.lower().split("x"))
        except ValueError:
            p.error(f"--mesh must look like 4x2, got {args.mesh!r}")
        if nc % mx or nc % my:
            p.error(f"--cells {nc} not divisible by mesh {mx}x{my}")

    dtype = args.dtype or default_dtype()
    cfg = bz.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns, impl=resolve_impl(args.impl),
        dtype=dtype, node_chunk=args.node_chunk,
        n_radial=args.n_radial or args.Nv, **vhs_kwargs(args),
    )
    if args.node_chunk is None:  # the cells of one device share its memory
        cfg = dataclasses.replace(
            cfg, node_chunk=cfg.auto_chunk(batch=nc * nc // (mx * my)))
    g = cfg.velocity_grid
    d = args.x_length / nc
    dt = args.dt or transport.cfl_dt(
        float(np.abs(np.asarray(g.v)).max()), d
    )
    collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
    if args.conserve:
        collide_fn = bz.conservative(
            collide_fn, bz.build_conserve_precomp(cfg, temperature=args.temperature)
        )

    if args.mesh:
        mesh = bz.make_mesh([("cx", mx), ("cy", my)])
        step = transport.make_sharded_step_2d(
            cfg, collide_fn, mesh, dx=d, dy=d, dt=dt, knudsen=args.knudsen,
            x_axis="cx", y_axis="cy", scheme=args.scheme, jit=False,
        )
        mode = (f"spatial decomposition {mx}x{my} devices, "
                f"{nc // mx}x{nc // my} cells/shard")
    else:
        mesh = None
        step = transport.make_inhomogeneous_step_2d(
            cfg, collide_fn, dx=d, dy=d, dt=dt, knudsen=args.knudsen,
            scheme=args.scheme,
        )
        mode = "single device, cells vmapped"

    f0 = taylor_green_f0(cfg, nc, u0=args.u0, temperature=args.temperature,
                         length=args.x_length)
    if mesh is not None:
        f0 = bz.place_cells(f0, mesh, x_axis="cx", y_axis="cy")

    dv3 = g.cell_volume
    # host np constants: embed in the jitted program as literals
    vx = np.asarray(g.vx, cfg.real_dtype).reshape(1, 1, -1, 1, 1)
    vy = np.asarray(g.vy, cfg.real_dtype).reshape(1, 1, 1, -1, 1)

    @jax.jit
    def diagnostics(f):
        # moments reduce on device; only 3 scalars cross the host boundary
        rho = jnp.sum(f, axis=(2, 3, 4)) * dv3
        mom_x = jnp.sum(f * vx, axis=(2, 3, 4)) * dv3
        mom_y = jnp.sum(f * vy, axis=(2, 3, 4)) * dv3
        ke = 0.5 * jnp.sum((mom_x**2 + mom_y**2) / rho) * d * d
        # total Boltzmann H = sum_cells H(f_cell) dx dy — non-increasing
        # along the full kinetic evolution (transport is H-neutral in the
        # continuum; collisions dissipate) — the no-oracle physics monitor
        h = jnp.sum(bz.entropy(f, cell_volume=dv3)) * d * d
        return jnp.sum(rho) * d * d, ke, h

    # chain every step inside ONE jitted program (one dispatch for the whole
    # run).  The scan carries the per-step H trace out as scalars
    # (negligible vs the collision work).
    @jax.jit
    def run(f, pre):
        def body(x, _):
            x = step(x, pre)
            return x, diagnostics(x)
        return jax.lax.scan(body, f, None, length=args.steps)

    print(f"\nkinetic Taylor-Green 2D×3V: {nc}x{nc} cells x "
          f"{'x'.join(str(s) for s in cfg.grid_shape)} velocities, "
          f"Ns={args.Ns} impl={cfg.impl} dtype={dtype} scheme={args.scheme}")
    print(f"dt={dt:.4f} Kn={args.knudsen} U0={args.u0} ({mode})")

    mass0, ke0, h0 = (float(v) for v in diagnostics(f0))
    best = None
    for trial in range(args.trials):
        t0 = time.perf_counter()
        f, (mass_tr, ke_tr, h_tr) = run(f0, pre)
        h_trace = np.asarray(h_tr, np.float64)  # D2H syncs the chain
        wall = time.perf_counter() - t0
        best = wall if best is None else min(best, wall)
        tag = " (compile)" if trial == 0 and args.trials > 1 else ""
        print(f"trial {trial}: {args.steps} steps in {wall:.2f}s = "
              f"{args.steps * nc * nc * 2 / wall:.1f} collision evals/s "
              f"aggregate{tag}")
    mass1, ke1 = float(mass_tr[-1]), float(ke_tr[-1])

    drift = abs(mass1 - mass0) / mass0
    print(f"total mass: {mass0:.6f} -> {mass1:.6f} (rel drift {drift:.2e}; "
          f"gain-quadrature mass-moment error at Ns={cfg.ns})")
    print(f"bulk-KE: {ke0:.6f} -> {ke1:.6f} "
          f"({100.0 * ke1 / ke0:.1f}% of initial)")
    trace = np.concatenate(([h0], h_trace))
    stride = max(1, args.steps // 8)
    samples = " ".join(
        f"{h:.6f}" for h in trace[:: stride][: (args.steps // stride) + 1]
    )
    print(f"H trace (every {stride} steps): {samples} -> {trace[-1]:.6f}")
    h_steps = np.diff(trace)
    worst_rise = float(h_steps.max())
    dissipated = h0 - float(trace[-1])
    print(f"H: {h0:.6f} -> {trace[-1]:.6f} (dissipated {dissipated:.3e}; "
          f"worst per-step rise {worst_rise:.3e})")
    if not (ke1 < ke0):
        print("FAIL: bulk kinetic energy must decay", file=sys.stderr)
        return 1
    if not np.isfinite(ke1) or drift > args.mass_tol:
        print("FAIL: conservation check", file=sys.stderr)
        return 1
    if not (dissipated > 0.0) or worst_rise > args.h_tol * dissipated:
        print("FAIL: H-theorem gate (entropy must dissipate monotonically "
              f"within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
