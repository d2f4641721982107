"""Example: relax a BKW distribution to equilibrium and track moments.

Run (CPU f64):
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python examples/bkw_relaxation.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

import boltzfft as bz


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--Nv", type=int, default=32)
    ap.add_argument("--Ns", type=int, default=12)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns)
    collide, pre = bz.make_collision_operator(cfg)
    g = cfg.velocity_grid
    v = jnp.asarray(g.v, cfg.real_dtype)

    t0, dt, steps = 5.5, 0.25, args.steps
    f0 = jnp.asarray(np.asarray(bz.bkw_f(g.r_squared(), t0)), cfg.real_dtype)

    run = bz.make_relaxation(
        collide, pre, dt=dt, n_steps=steps, method="rk4",
        record=lambda f: bz.moments(f, v, g.dv),
    )
    traj = run(f0)
    m = traj.recorded

    print(f"BKW relaxation, Nv={cfg.nv}, Ns={cfg.ns}, dt={dt}")
    print(f"{'t':>6} {'mass':>12} {'energy':>12} {'temperature':>12}")
    for i in range(steps):
        t = t0 + (i + 1) * dt
        print(
            f"{t:6.2f} {float(m.mass[i]):12.8f} "
            f"{float(m.energy[i]):12.8f} {float(m.temperature[i]):12.8f}"
        )

    # compare endpoint against the analytic BKW solution
    t_end = t0 + steps * dt
    err = bz.error_norms(
        np.asarray(traj.f), bz.bkw_f(g.r_squared(), t_end), g.dv
    )
    print(f"\nLinf vs analytic BKW at t={t_end}: {err['Linf']:.3e}")


if __name__ == "__main__":
    main()
