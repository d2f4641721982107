"""Example: 2D×3V kinetic mixing — a density blob shearing in periodic flow.

Two Maxwellian populations with opposite bulk x-velocities stacked in y
shear a density perturbation while collisions (Kn = 0.5) drive each cell
toward local equilibrium.  Demonstrates the 2D Strang-split solver
(`transport.make_inhomogeneous_step_2d`: MUSCL advection along both
spatial axes + per-cell collisions) and conservation diagnostics.

Run (CPU f64):
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python examples/mixing_2d3v.py

Pass ``--shard`` to run the same problem spatially decomposed over the
available devices (`transport.make_sharded_step_2d`: shard_map with
ppermute halo exchange, shard-local collision FFTs) — e.g. with an
8-device virtual CPU mesh:
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \\
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/mixing_2d3v.py --shard
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import boltzfft as bz
from boltzfft import transport
from boltzfft.bkw import maxwellian


def main():
    cfg = bz.CollisionConfig(nv=16, ns=6, n_radial=6, impl="rfft")
    collide, pre = bz.make_collision_operator(cfg, jit=False)
    g = cfg.velocity_grid

    nx = ny = 12
    lx = ly = 1.0
    dx, dy = lx / nx, ly / ny
    dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), min(dx, dy))
    steps = 8

    # density blob on a shear background: top half drifts +x, bottom -x
    rsq = np.asarray(g.r_squared())
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    blob = 1.0 + 0.5 * np.exp(
        -((x[:, None] - 0.5) ** 2 + (y[None, :] - 0.5) ** 2) / 0.02
    )  # (nx, ny)
    vsq_up = np.asarray(
        (g.vx[:, None, None] - 1.0) ** 2
        + g.vy[None, :, None] ** 2
        + g.vz[None, None, :] ** 2
    )
    vsq_dn = np.asarray(
        (g.vx[:, None, None] + 1.0) ** 2
        + g.vy[None, :, None] ** 2
        + g.vz[None, None, :] ** 2
    )
    m_up = np.asarray(maxwellian(vsq_up, density=1.0, temperature=3.0))
    m_dn = np.asarray(maxwellian(vsq_dn, density=1.0, temperature=3.0))
    shear = np.where((np.arange(ny) < ny // 2)[:, None, None, None], m_dn, m_up)
    f0 = jnp.asarray(
        blob[:, :, None, None, None] * shear[None], cfg.real_dtype
    )  # (nx, ny, Nv, Nv, Nv)

    if "--shard" in sys.argv[1:]:
        n_dev = len(jax.devices())
        mx = 4 if n_dev % 4 == 0 and nx % 4 == 0 else 2
        my = max(1, min(n_dev // mx, 2))
        mesh = bz.make_mesh([("cx", mx), ("cy", my)])
        print(f"spatial decomposition: {mx}x{my} device mesh, "
              f"{nx // mx}x{ny // my} cells per shard")
        step = transport.make_sharded_step_2d(
            cfg, collide, mesh, dx=dx, dy=dy, dt=dt, knudsen=0.5,
            x_axis="cx", y_axis="cy", jit=False,
        )
        f0 = bz.place_cells(f0, mesh, x_axis="cx", y_axis="cy")
    else:
        step = transport.make_inhomogeneous_step_2d(
            cfg, collide, dx=dx, dy=dy, dt=dt, knudsen=0.5
        )

    run = jax.jit(
        lambda f, p: jax.lax.fori_loop(0, steps, lambda i, s: step(s, p), f)
    )

    dv3 = g.cell_volume
    rho0 = np.asarray(jnp.sum(f0, axis=(2, 3, 4))) * dv3
    f1 = run(f0, pre)
    rho1 = np.asarray(jnp.sum(f1, axis=(2, 3, 4))) * dv3

    print(f"2D×3V mixing: {nx}x{ny} cells, {cfg.nv}^3 velocities, "
          f"{steps} Strang steps of dt={dt:.4f} (Kn=0.5)")
    print(f"total mass {rho0.sum():.6f} -> {rho1.sum():.6f} "
          f"(rel drift {abs(rho1.sum() - rho0.sum()) / rho0.sum():.2e})")
    print(f"density contrast (max/min): {rho0.max()/rho0.min():.3f} -> "
          f"{rho1.max()/rho1.min():.3f}  (shear + collisions mix the blob)")
    row = rho1[:, ny // 4]
    print("density sample (y = L/4 row):",
          " ".join(f"{r:.3f}" for r in row[:: max(1, nx // 8)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
