"""Example: the float32 accuracy/cost ladder.

Evaluates the same BKW configuration through each float32 pipeline and
prints error vs wall time:

  dft (default)     DFT matrix products at the device's fastest f32 precision
                    (TF32 on a GPU with tensor cores)
  dft (highest)     DFT matrix products at full f32 precision
  rfft              staged cuFFT/XLA pipeline, f32-best accuracy
  ds                compensated double-single: f64-class digits from
                    float32 pairs (boltzfft/ds_operator.py)

Run (any backend):
    python examples/precision_ladder.py --Nv 16
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import boltzfft as bz
from boltzfft import ds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--Nv", type=int, default=16)
    p.add_argument("--Ns", type=int, default=6)
    args = p.parse_args(argv)

    cfg0 = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, dtype="float32")
    g = cfg0.velocity_grid
    rsq = g.r_squared()
    f64 = np.asarray(bz.bkw_f(rsq, 6.5), np.float64)
    q64 = np.asarray(bz.bkw_dfdt(rsq, 6.5), np.float64)
    dv3 = g.dv ** 3

    # The compensated pipeline doubles as the on-accelerator f64-class
    # oracle: its result separates arithmetic error from method error for
    # every other pipeline, even on backends with no float64.
    collide_ds, pre_ds = bz.make_ds_collision_operator(cfg0, jit=False)
    f_ds = ds.from_f64(f64)
    qex = ds.from_f64(q64)

    @jax.jit
    def run_ds(f, pre, qex):
        q = collide_ds(f, pre)
        d = ds.sub(q, qex)
        return q.hi + q.lo, jnp.max(jnp.abs(d.hi + d.lo))

    q_ds, linf_ds = run_ds(f_ds, pre_ds, qex)  # compile + first
    t0 = time.perf_counter()
    q_ds, linf_ds = run_ds(f_ds, pre_ds, qex)
    float(linf_ds)
    dt_ds = time.perf_counter() - t0
    q_ds = np.asarray(q_ds, np.float64)

    print(f"{'pipeline':>16} {'Linf vs BKW':>12} {'arith error':>12} {'s/eval':>10}")
    print(f"{'':>16} {'(method+arith)':>12} {'(vs ds)':>12}")

    variants = [
        ("dft default", dict(impl="dft", dft_precision="default")),
        ("dft highest", dict(impl="dft", dft_precision="highest")),
        ("rfft", dict(impl="rfft")),
    ]
    for name, kw in variants:
        cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, dtype="float32", **kw)
        collide, pre = bz.make_collision_operator(cfg)
        f = jnp.asarray(f64, jnp.float32)
        q = collide(f, pre)
        float(jnp.sum(q))  # sync
        t0 = time.perf_counter()
        q = collide(f, pre)
        float(jnp.sum(q))
        dt = time.perf_counter() - t0
        qn = np.asarray(q, np.float64)
        print(f"{name:>16} {np.abs(qn - q64).max():12.4e} "
              f"{np.abs(qn - q_ds).max():12.4e} {dt:10.4f}")

    print(f"{'ds (compensated)':>16} {float(linf_ds):12.4e} {'oracle':>12} "
          f"{dt_ds:10.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
