"""Space-inhomogeneous 1D×3V demo: a Sod-type kinetic shock tube.

Solves ``df/dt + v_x df/dx = Q(f,f)/Kn`` with Strang splitting (periodic
MUSCL/minmod transport by default, first-order upwind via --scheme; per-cell
collisions on the ensemble axis), printing
density/temperature profiles and conservation diagnostics.  The reference
code has no spatial transport at all (SURVEY.md section 0); this is the
production workload its collision kernel feeds.

    python -m boltzfft.cli.sod_1d3v --Nv 16 --Ns 12 --nx 32 --steps 20
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser

    p = standard_parser(__doc__)
    p.set_defaults(impl="auto")
    p.add_argument("--nx", type=int, default=32, help="spatial cells (periodic)")
    p.add_argument("--x-length", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--knudsen", type=float, default=0.5)
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: CFL-limited for the transport)")
    p.add_argument("--mesh-cells", type=int, default=None,
                   help="shard cells over this many devices (ensemble axis)")
    p.add_argument("--scheme", choices=["muscl", "upwind"], default="muscl",
                   help="advection scheme (muscl = 2nd-order TVD, default)")
    p.add_argument("--conserve", action="store_true",
                   help="project every Q onto vanishing invariant moments\n(bz.conservative): exact per-step conservation")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H increase as "
                        "a fraction of the total dissipation |H_end - H_0|")
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default, resolve_impl
    enable_cache_default()

    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import transport

    dtype = args.dtype or default_dtype()
    cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, impl=resolve_impl(args.impl),
                             dtype=dtype, node_chunk=args.node_chunk,
                             n_radial=args.n_radial or args.Nv)
    if args.node_chunk is None:  # the cells of one device share its memory
        cfg = dataclasses.replace(cfg, node_chunk=cfg.auto_chunk(
            batch=args.nx // max(1, args.mesh_cells or 1)))
    g = cfg.velocity_grid
    dx = args.x_length / args.nx
    dt = args.dt or transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), dx)

    if args.mesh_cells and args.mesh_cells > 1:
        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, args.mesh_cells)])
        collide_fn, pre = bz.make_sharded_collision_operator(
            cfg, mesh, node_axis=None, ensemble_axis=bz.ENSEMBLE_AXIS, jit=False
        )
        if args.conserve:
            collide_fn = bz.conservative(
                collide_fn, bz.build_conserve_precomp(cfg, temperature=1.0)
            )
        step = transport.make_inhomogeneous_step(
            cfg, collide_fn, dx=dx, dt=dt, knudsen=args.knudsen,
            vmap_cells=False, scheme=args.scheme,
        )
    else:
        collide_fn, pre = bz.make_collision_operator(cfg, jit=False)
        if args.conserve:
            collide_fn = bz.conservative(
                collide_fn, bz.build_conserve_precomp(cfg, temperature=1.0)
            )
        step = transport.make_inhomogeneous_step(
            cfg, collide_fn, dx=dx, dt=dt, knudsen=args.knudsen,
            scheme=args.scheme,
        )

    f = transport.sod_initial_condition(cfg, args.nx)
    print(f"\nSod 1D×3V: nx={args.nx} dx={dx:.4f} dt={dt:.4f} "
          f"Kn={args.knudsen} Nv={args.Nv} Ns={args.Ns} impl={cfg.impl} "
          f"scheme={args.scheme}")

    dx_w = args.x_length / args.nx

    def h_total(f):
        # total Boltzmann H = sum_cells H(f_cell) dx — the no-oracle
        # physics monitor (non-increasing along the kinetic evolution)
        return jnp.sum(bz.entropy(f, g.dv)) * dx_w

    # chain every step in ONE jitted program, carrying the per-step H
    # trace out as scalars (negligible work vs the collision substep)
    @jax.jit
    def run(f, pre):
        def body(x, _):
            x = step(x, pre)
            return x, h_total(x)
        return jax.lax.scan(body, f, None, length=args.steps)

    mass0 = float(transport.density_profile(f, g.dv).sum())
    h0 = float(h_total(f))
    t0 = time.perf_counter()
    f, h_tr = run(f, pre)
    rho = np.asarray(transport.density_profile(f, g.dv))
    h_trace = np.asarray(h_tr, np.float64)
    wall = time.perf_counter() - t0
    mass1 = float(rho.sum())

    print(f"{args.steps} steps in {wall:.2f}s "
          f"({args.steps * args.nx * 2 / wall:.1f} collision evals/s aggregate)")
    print(f"total mass: {mass0:.6f} -> {mass1:.6f} "
          f"(rel drift {abs(mass1 - mass0) / mass0:.2e})")
    trace = np.concatenate(([h0], h_trace))
    stride = max(1, args.steps // 8)
    samples = " ".join(
        f"{h:.6f}" for h in trace[:: stride][: (args.steps // stride) + 1]
    )
    print(f"H trace (every {stride} steps): {samples} -> {trace[-1]:.6f}")
    worst_rise = float(np.diff(trace).max())
    dissipated = h0 - float(trace[-1])
    print(f"H: {h0:.6f} -> {trace[-1]:.6f} (dissipated {dissipated:.3e}; "
          f"worst per-step rise {worst_rise:.3e})")
    edges = np.linspace(0, args.x_length, 9)[:-1]
    sampled = rho[:: max(1, args.nx // 8)][:8]
    print("density profile (8 samples):")
    for x, r in zip(edges, sampled):
        print(f"  x={x:.3f}: rho={r:.5f}")
    if not (dissipated > 0.0) or worst_rise > args.h_tol * dissipated:
        print("FAIL: H-theorem gate (entropy must dissipate monotonically "
              f"within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
