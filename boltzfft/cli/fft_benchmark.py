"""Batched 3-D FFT microbenchmark — rebuild of ``fftw_benchmark.cpp`` /
``cufft_benchmark.cu``.

The reference compares FFTW plan strategies (plan-many vs manual batching vs
exhaustive planning, ``fftw_benchmark.cpp:104-292``); the XLA analog compares
transform variants on one batched call: c2c vs rfft, one-shot vs node-chunked
scan.  Batch size matches the reference: ``Ns * Nv`` grids of ``Nv^3``
(``fftw_benchmark.cpp:69``).  Round-trip L1 error is checked like the
reference (``fftw_benchmark.cpp:150-170``); the run fails if a variant fails
or its mean round-trip error exceeds the dtype's bound.
"""

from __future__ import annotations

import sys
import time
from functools import partial



def main(argv=None):
    from boltzfft.cli import default_dtype, standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--chain", type=int, default=8, help="FFT passes chained per timed jit call")
    args = p.parse_args(argv)

    from boltzfft.cli import enable_cache_default
    enable_cache_default()

    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    dtype = args.dtype or default_dtype()
    n, batch = args.Nv, args.Ns * args.Nv
    trials = max(args.trials, 3)
    print(f"\nBatched 3D FFT benchmark: batch={batch} of {n}^3, dtype={dtype}, chain={args.chain}")

    rd = jnp.float64 if dtype == "float64" else jnp.float32
    cd = jnp.complex128 if dtype == "float64" else jnp.complex64
    g = bz.VelocityGrid(nv=n, length=bz.domain_from_support()[1])
    # upload one grid, broadcast to the batch on device
    one = jnp.asarray(bz.bkw_f(g.r_squared(), 6.5), rd)
    x = jax.jit(lambda a: jnp.broadcast_to(a, (batch, n, n, n)) * 1.0)(one)

    results = {}
    failed = []
    # mean |roundtrip(x) - x| bound: far above roundoff, far below any
    # transform fault (the BKW data is O(1e-2))
    err_tol = 1e-12 if dtype == "float64" else 1e-6

    def timed(label, fn, arg):
        # chain k round trips with a data dependency; sync via D2H read
        @partial(jax.jit, static_argnums=1)
        def chain(a, k):
            return jax.lax.fori_loop(0, k, lambda i, y: fn(y), a)

        try:
            out = chain(arg, args.chain)
            float(jnp.sum(jnp.abs(out[0, 0, 0])))
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                out = chain(arg, args.chain)
                float(jnp.sum(jnp.abs(out[0, 0, 0])))
                best = min(best, time.perf_counter() - t0)
            per_pass = best / args.chain
            results[label] = per_pass
            # round-trip error after one pass (fn is identity up to roundoff)
            err = float(jnp.mean(jnp.abs(fn(arg) - arg)))
            print(f"{label:34s} {per_pass:.4e} s/round-trip   L1 err {err:.3e}")
            if not err <= err_tol:
                failed.append(f"{label}: L1 err {err:.3e} > {err_tol:.0e}")
        except Exception as e:
            # a variant that doesn't fit (e.g. the full-batch c2c working set
            # at 64^3 x Ns*Nv grids) reports and the sweep continues — like
            # the reference's per-strategy sections (fftw_benchmark.cpp) —
            # and the run fails at the end
            print(f"{label:34s} FAILED: {type(e).__name__}: {str(e)[:120]}")
            failed.append(f"{label}: {type(e).__name__}")

    axes = (-3, -2, -1)
    timed(
        "c2c fftn+ifftn (one batch)",
        lambda y: jnp.fft.ifftn(jnp.fft.fftn(y, axes=axes), axes=axes),
        x.astype(cd),
    )
    timed(
        "rfftn+irfftn (one batch)",
        lambda y: jnp.fft.irfftn(jnp.fft.rfftn(y, axes=axes), s=(n, n, n), axes=axes),
        x,
    )

    n_chunks = 4 if batch % 4 == 0 else 1

    def chunked_roundtrip(y):
        z = y.reshape(n_chunks, batch // n_chunks, n, n, n)

        def body(carry, blk):
            return carry, jnp.fft.irfftn(
                jnp.fft.rfftn(blk, axes=axes), s=(n, n, n), axes=axes
            )

        _, out = jax.lax.scan(body, 0, z)
        return out.reshape(batch, n, n, n)

    timed(f"rfftn+irfftn (scan over {n_chunks} chunks)", chunked_roundtrip, x)

    if results:
        best = min(results, key=results.get)
        print(f"\nFastest: {best} ({results[best]:.4e} s)")
    if failed:
        print("FAIL: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
