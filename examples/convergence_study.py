"""Example: spectral convergence of Q(f, f) against the analytic BKW rate.

Sweeps the velocity resolution at fixed quadrature and prints the L1/L2/Linf
error ladder — the study behind the reference's accuracy tables
(``Results/maxwell_bkw_fftw_atomics.txt``): the error should fall
spectrally (faster than any power of 1/Nv) until it hits the quadrature or
arithmetic floor.

Run (CPU f64):
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python examples/convergence_study.py
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
    ap.add_argument("--max-nv", type=int, default=64,
                    help="largest grid in the ladder (64 = full study)")
    ap.add_argument("--Ns", type=int, default=12)
    args = ap.parse_args(argv)

    print(f"{'Nv':>4} {'L1':>12} {'L2':>12} {'Linf':>12}")
    for nv in (8, 16, 24, 32, 48, 64):
        if nv > args.max_nv:
            break
        cfg = bz.CollisionConfig(nv=nv, ns=args.Ns, n_radial=nv)
        collide, pre = bz.make_collision_operator(cfg)
        g = cfg.velocity_grid
        rsq = g.r_squared()
        f = jnp.asarray(np.asarray(bz.bkw_f(rsq, 6.5)), cfg.real_dtype)
        q = np.asarray(collide(f, pre))
        err = bz.error_norms(q, np.asarray(bz.bkw_dfdt(rsq, 6.5)), g.dv)
        print(f"{nv:4d} {err['L1']:12.4e} {err['L2']:12.4e} {err['Linf']:12.4e}")
    print("\n(spectral decay to the f64 floor; 64^3 reference: Linf 3.0685e-12)")


if __name__ == "__main__":
    sys.exit(main())
