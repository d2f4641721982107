"""Sharded-ensemble relaxation driver (BASELINE config 5).

Relaxes an ensemble of independent BKW distributions — a proxy for the spatial
cells of a 0D-3V space-inhomogeneous solve — sharded over the device mesh
(ensemble x node axes), with on-device moment tracking.  The reference has no
equivalent (it is single-distribution, single-device); this exercises the
multi-device scaling path end to end.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--ensemble", type=int, default=8, help="number of distributions")
    p.add_argument("--steps", type=int, default=5, help="RK4 steps")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--ens-mesh", type=int, default=None,
                   help="devices on the ensemble axis (default: all)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="orbax checkpoint directory; resumes from the latest "
                        "step if one exists")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="RK4 steps between checkpoints (0 = only at the end)")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H rise as a "
                        "fraction of that member's total dissipation (tail-"
                        "quadrature noise makes coarse grids, Nv<32, mildly "
                        "non-monotone on exact BKW data — the Nv=32 oracle "
                        "test asserts strict monotonicity)")
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default, resolve_impl
    enable_cache_default()

    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    dtype = args.dtype or default_dtype()
    n_dev = len(jax.devices())
    ens_mesh = args.ens_mesh or n_dev
    node_mesh = n_dev // ens_mesh
    if args.ensemble % ens_mesh:
        raise SystemExit(f"--ensemble {args.ensemble} must divide by ensemble mesh {ens_mesh}")

    axes = [(bz.ENSEMBLE_AXIS, ens_mesh)]
    if node_mesh > 1:
        axes.append((bz.NODE_AXIS, node_mesh))
    mesh = bz.make_mesh(axes)
    print(f"\nEnsemble relaxation: E={args.ensemble}, Nv={args.Nv}, Ns={args.Ns}, "
          f"mesh={dict(zip(mesh.axis_names, mesh.devices.shape))}, dtype={dtype}")

    cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, impl=resolve_impl(args.impl), dtype=dtype,
                             node_chunk=args.node_chunk)
    if args.node_chunk is None:  # the members of one device share its memory
        cfg = dataclasses.replace(cfg, node_chunk=cfg.auto_chunk(
            batch=args.ensemble // ens_mesh))
    collide_fn, pre = bz.make_sharded_collision_operator(
        cfg, mesh,
        node_axis=bz.NODE_AXIS if node_mesh > 1 else None,
        ensemble_axis=bz.ENSEMBLE_AXIS,
        jit=False,
    )
    pre = bz.place(pre, mesh, node_axis=bz.NODE_AXIS if node_mesh > 1 else None)

    g = cfg.velocity_grid
    rsq = g.r_squared()
    # ensemble of BKW states at staggered times (independent distributions)
    ts = 5.5 + 2.0 * np.arange(args.ensemble) / max(args.ensemble, 1)
    f0 = jnp.asarray(
        np.stack([np.asarray(bz.bkw_f(rsq, t)) for t in ts]), cfg.real_dtype
    )
    # host np constant: embeds in the jitted program as a literal
    v = np.asarray(g.v, cfg.real_dtype)

    if args.checkpoint_dir:
        return _run_checkpointed(args, bz, cfg, collide_fn, pre, f0, v, g)

    run = bz.make_relaxation(
        collide_fn, pre, dt=args.dt, n_steps=args.steps, method="rk4",
        record=lambda f: (bz.moments(f, v, g.dv), bz.entropy(f, g.dv)),
    )
    t0 = time.perf_counter()
    traj = run(f0)
    mass = np.asarray(traj.recorded[0].mass)  # D2H read synchronizes
    compile_and_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    traj = run(f0)
    mass = np.asarray(traj.recorded[0].mass)
    run_time = time.perf_counter() - t0

    evals = args.ensemble * args.steps * 4  # RK4: 4 collision evals/step
    print(f"first call (compile+run): {compile_and_run:.3f}s; steady run: {run_time:.4f}s")
    print(f"collision evals: {evals} -> {evals / run_time:.1f} evals/s aggregate")
    print(f"final mass range: [{mass[-1].min():.6f}, {mass[-1].max():.6f}]")
    print(f"final temperature range: "
          f"[{np.asarray(traj.recorded[0].temperature)[-1].min():.6f}, "
          f"{np.asarray(traj.recorded[0].temperature)[-1].max():.6f}]")
    # H-theorem monitor: per-member H traces (steps, E) must dissipate
    # monotonically along the homogeneous relaxation (bz.entropy oracle
    # tests calibrate the convention; no analytic solution needed)
    h = np.asarray(traj.recorded[1], np.float64)
    h0 = np.asarray(bz.entropy(f0, g.dv), np.float64)
    h_steps = np.diff(np.concatenate([h0[None], h]), axis=0)
    dissipated = h0 - h[-1]  # per member
    print(f"H range: [{h0.min():.6f}, {h0.max():.6f}] -> "
          f"[{h[-1].min():.6f}, {h[-1].max():.6f}] "
          f"(worst per-step rise {h_steps.max():.3e})")
    if not (np.all(dissipated > 0.0)
            and np.all(h_steps.max(axis=0) <= args.h_tol * dissipated)):
        print("FAIL: H-theorem gate (every member's H must dissipate "
              f"monotonically within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


def _run_checkpointed(args, bz, cfg, collide_fn, pre, f0, v, g):
    """Segmented relaxation with orbax checkpoint/resume: the production
    long-run path (preemptible capacity).  Resumes from the latest step in
    ``--checkpoint-dir`` when present."""
    import jax
    import numpy as np

    seg = args.checkpoint_every or args.steps
    # Segment runners per length: the final (or resume-misaligned) segment is
    # min(seg, remaining) steps so the checkpointed trajectory is step-for-step
    # identical to an uninterrupted run (no overshoot past --steps).
    runners = {}

    def run_for(n_steps):
        if n_steps not in runners:
            runners[n_steps] = bz.make_relaxation(
                collide_fn, pre, dt=args.dt, n_steps=n_steps, method="rk4",
                record=lambda f: bz.moments(f, v, g.dv),
            )
        return runners[n_steps]

    with bz.RelaxCheckpointer(args.checkpoint_dir) as ck:
        start, t_sim, f = 0, 0.0, f0
        latest = ck.latest_step()
        if latest is not None:
            f, t_sim = ck.restore(latest, template=f0)
            start = latest
            print(f"resumed from step {start} (t = {t_sim:.4f})")
        step = start
        t0 = time.perf_counter()
        while step < args.steps:
            this_seg = min(seg, args.steps - step)
            traj = run_for(this_seg)(f)
            f = traj.f
            step += this_seg
            t_sim += this_seg * args.dt
            jax.block_until_ready(f)
            ck.save(step, f, t_sim)
            mass = np.asarray(traj.recorded.mass)
            print(f"step {step}/{args.steps} t={t_sim:.4f} "
                  f"mass=[{mass[-1].min():.6f}, {mass[-1].max():.6f}]")
        ck.wait()
        wall = time.perf_counter() - t0
    done = max(args.steps - start, 0)
    evals = args.ensemble * done * 4
    if done:
        print(f"{done} steps ({evals} collision evals) in {wall:.2f}s "
              f"incl. checkpoint I/O; state in {args.checkpoint_dir}")
    else:
        print("nothing to do: checkpoint already at final step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
