"""Hot-loop (non-FFT) scheduling benchmark — rebuild of
``loop_benchmark_cpu.cpp`` / ``loop_benchmark_gpu.cpp``.

The reference isolates the two elementwise/contraction hot patterns and
explores OpenMP schedules (collapse/simd/tiling, atomics vs reduction,
``loop_benchmark_cpu.cpp:153-435``).  The XLA analog compares formulations of
the same two patterns:

  pattern 1 — broadcast multiply: alpha1(b,l) * f_hat(l) (both alpha1*f and
              conj(alpha1)*f), with alpha built on the fly from separable
              per-axis factors vs a materialized full alpha table;
  pattern 2 — gain contraction: sum_b w(b,l) * h_hat(b,l), as einsum (the
              deterministic replacement for the reference's atomics) vs an
              explicit scan accumulation.
"""

from __future__ import annotations

import sys
import time
from functools import partial



def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--chain", type=int, default=8)
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default
    enable_cache_default()

    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    dtype = args.dtype or default_dtype()
    cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, impl="c2c", dtype=dtype)
    pre = bz.build_precomp(cfg)
    n, b = cfg.nv, cfg.n_nodes_padded
    trials = max(args.trials, 3)
    print(f"\nHot-loop benchmark: B={b} nodes, {n}^3 grid, dtype={dtype}")

    cd = cfg.complex_dtype
    rd = cfg.real_dtype
    # synthetic data generated on device from a seed
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 4)
    f_hat = (jax.random.normal(k0, (n, n, n), rd)
             + 1j * jax.random.normal(k1, (n, n, n), rd)).astype(cd)
    h_hat = (jax.random.normal(k2, (b, n, n, n), rd)
             + 1j * jax.random.normal(k3, (b, n, n, n), rd)).astype(cd)

    results = {}

    def timed(label, fn, *fn_args):
        @partial(jax.jit, static_argnums=0)
        def chain(k, *a):
            def body(i, acc):
                out = fn(*a)
                leaf = out[0] if isinstance(out, tuple) else out
                return acc + jnp.sum(jnp.real(leaf)) * 1e-30
            return jax.lax.fori_loop(0, k, body, jnp.zeros((), cfg.real_dtype))

        float(chain(args.chain, *fn_args))
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            float(chain(args.chain, *fn_args))
            best = min(best, time.perf_counter() - t0)
        results[label] = best / args.chain
        print(f"{label:44s} {best / args.chain:.4e} s/pass")

    from boltzfft.operator import _alpha_factors, _beta1

    # -- pattern 1: alpha-multiply ------------------------------------------
    def p1_separable(fh):
        ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
        a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
        return a1 * fh[None], jnp.conj(a1) * fh[None]

    ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
    alpha_full = jax.jit(
        lambda a, b_, c_: a[:, :, None, None] * b_[:, None, :, None] * c_[:, None, None, :]
    )(ax, ay, az)  # materialized once, stays on device

    def p1_materialized(fh, alpha):
        return alpha * fh[None], jnp.conj(alpha) * fh[None]

    timed("pattern1 alpha*f_hat (separable on-the-fly)", p1_separable, f_hat)
    timed("pattern1 alpha*f_hat (materialized table)", p1_materialized, f_hat, alpha_full)

    # -- pattern 2: gain contraction ----------------------------------------
    def weights():
        w = pre.gain_w[:, None, None, None] * _beta1(cfg, pre, pre.rho)
        return w.astype(cd)

    def p2_einsum(hh):
        return jnp.sum(weights() * hh, axis=0)

    def p2_scan(hh):
        w = weights()

        def body(acc, blk):
            wi, hi = blk
            return acc + wi * hi, None

        out, _ = jax.lax.scan(body, jnp.zeros((n, n, n), cd), (w, hh))
        return out

    timed("pattern2 gain reduce (einsum)", p2_einsum, h_hat)
    timed("pattern2 gain reduce (scan accumulate)", p2_scan, h_hat)

    best = min(results, key=results.get)
    print(f"\nFastest: {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
