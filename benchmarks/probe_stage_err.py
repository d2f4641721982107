"""Stage-wise f32 error attribution for the staged rfft pipeline.

Question (round-4 open item, docs/PERFORMANCE.md "accuracy midpoint"): the
f32 pipelines carry ~3.7e-8 *internal* error beyond the 9.9e-10 input
quantization floor.  A selectively-compensated pipeline (EFT folds only on
the growing stages) could reach ~1e-9 at staged speeds — but only if the
error lives in a *compensatable* stage (products, node accumulation) rather
than inside the FFT butterflies themselves (compensating those IS the ds
pipeline, at ds cost).

Method: evaluate Q(f,f) through the staged rfft pipeline entirely in f64
(truth), then re-evaluate with exactly ONE stage emulated at f32 (inputs
cast to f32/c64, the stage's ops run at that dtype, result cast back to
f64).  The one-hot error attributes the all-f32 budget to stages.  Stages
mirror ``operator.collide`` / ``operator._gain_chunk``
(reference pipeline: ``FFTWBoltzmannOperator.cpp:147-334``):

  input  f -> f32                       (the known 9.9e-10-class floor)
  fwd    f_hat = rfftn(f)               FFT butterflies
  alpha  a1 = ax*ay*az, a1*f_hat        per-node phase products
  inv    g1,g2 = irfftn(a1f), ...       FFT butterflies (B nodes x 2)
  had    g1*g2                          pointwise product
  fwd2   h_hat = rfftn(g1*g2)           FFT butterflies (B nodes)
  wsum   sum_b w_b beta1_b h_hat_b      node accumulation (the classic
                                        compensated-sum target)
  finale_b2mul    beta2 * f_hat         pointwise product (compensatable)
  finale_fft      irfftn(q_gain_hat), irfftn(beta2*f_hat)   FFT butterflies
  finale_assembly Q = q_gain - loss*f   product + cancelling subtraction
                                        (compensatable; carries the ~4.4x
                                        |gain|/|Q| cancellation amplification)

The finale is split at this granularity (round-4 advisor finding) so the
"ffts" group holds ONLY transform butterflies: the loss multiply and the
gain-loss subtraction are products/sums an EFT-compensated pipeline could
fix, and lumping them with the inverse transforms overstated the
non-compensatable floor.

Run on CPU with x64:
  JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \
      python benchmarks/probe_stage_err.py --Nv 32 [--Nv 64]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--Nv", type=int, default=32)
    ap.add_argument("--Ns", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=8)
    args = ap.parse_args()

    import jax

    if jax.config.jax_enable_x64 is not True:
        print("needs x64 (run with the CPU env; see module docstring)")
        return 1
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft.operator import _FFT_AXES, _alpha_factors, _beta1

    cfg = bz.CollisionConfig(nv=args.Nv, ns=args.Ns, dtype="float64")
    _, pre = bz.make_collision_operator(cfg, jit=False)
    f = np.asarray(
        bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=np.float64
    )
    shape = cfg.grid_shape

    C64, C128 = jnp.complex64, jnp.complex128

    def run(stage32) -> np.ndarray:
        """One eval; the named stage(s) run at f32/c64 ('' = none)."""
        stage32 = {stage32} if isinstance(stage32, str) else set(stage32)

        def st(name, op, *xs, cdtype=C64, rdtype=jnp.float32):
            """Run op at f32 when `name` is a chosen stage, else f64."""
            if name not in stage32:
                return op(*xs)
            lo = tuple(
                x.astype(cdtype if jnp.iscomplexobj(x) else rdtype) for x in xs
            )
            y = op(*lo)
            up = lambda v: v.astype(C128 if jnp.iscomplexobj(v) else jnp.float64)
            return tuple(up(v) for v in y) if isinstance(y, tuple) else up(y)

        fx = st("input", lambda x: x, jnp.asarray(f))
        f_hat = st("fwd", lambda x: jnp.fft.rfftn(x, axes=_FFT_AXES), fx)

        b = pre.rho.shape[0]
        c = args.chunk
        parts = []
        for i in range(0, b, c):
            rho, sigma, gw = pre.rho[i : i + c], pre.sigma[i : i + c], pre.gain_w[i : i + c]
            ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)

            def alpha_stage(ax, ay, az, fh):
                a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
                return a1 * fh[None], jnp.conj(a1) * fh[None]

            a1f, a2f = st("alpha", alpha_stage, ax, ay, az, f_hat)
            g1 = st("inv", lambda x: jnp.fft.irfftn(x, s=shape, axes=_FFT_AXES), a1f)
            g2 = st("inv", lambda x: jnp.fft.irfftn(x, s=shape, axes=_FFT_AXES), a2f)
            gg = st("had", lambda a, b: a * b, g1, g2)
            h_hat = st("fwd2", lambda x: jnp.fft.rfftn(x, axes=_FFT_AXES), gg)
            w = gw[:, None, None, None] * _beta1(cfg, pre, rho)
            parts.append((w, h_hat))

        def wsum_stage(*flat):
            ws, hs = flat[: len(parts)], flat[len(parts) :]
            acc = jnp.zeros(hs[0].shape[1:], hs[0].dtype)
            for w, h in zip(ws, hs):  # sequential, like the lax.scan carry
                acc = acc + jnp.sum(w.astype(h.dtype) * h, axis=0)
            return acc

        q_gain_hat = st("wsum", wsum_stage, *[w for w, _ in parts], *[h for _, h in parts])

        b2fh = st(
            "finale_b2mul", lambda fh: pre.beta2.astype(fh.dtype) * fh, f_hat
        )

        def fin_fft(qgh, bf):
            return (
                jnp.fft.irfftn(qgh, s=shape, axes=_FFT_AXES),
                jnp.fft.irfftn(bf, s=shape, axes=_FFT_AXES),
            )

        q_gain, loss = st("finale_fft", fin_fft, q_gain_hat, b2fh)
        return np.asarray(
            st("finale_assembly", lambda qg, lo, x: qg - lo * x,
               q_gain, loss, fx)
        )

    truth = run("")
    scale = np.abs(truth).max()
    # Cancellation amplification: Q = gain - loss*f, with |gain| >> |Q| near
    # equilibrium — merely *storing* gain/loss at f32 costs |gain|/|Q| * eps.
    fh64 = jnp.fft.rfftn(jnp.asarray(f), axes=_FFT_AXES)
    loss64 = jnp.fft.irfftn(pre.beta2.astype(fh64.dtype) * fh64, s=shape,
                            axes=_FFT_AXES) * jnp.asarray(f)
    gain_mag = float(np.abs(truth + np.asarray(loss64)).max())
    print(f"# Nv={args.Nv} Ns={args.Ns} B={pre.rho.shape[0]} nodes  "
          f"max|Q64|={scale:.3e}  max|gain|/max|Q|={gain_mag / scale:.1f}  "
          f"(rel Linf vs all-f64 truth)")
    stages = ["input", "fwd", "alpha", "inv", "had", "fwd2", "wsum",
              "finale_b2mul", "finale_fft", "finale_assembly"]
    errs = {}
    for s in stages:
        q = run(s)
        errs[s] = np.abs(q - truth).max() / scale
        print(f"{s:16s} {errs[s]:.3e}")
    tot = np.sqrt(sum(e * e for e in errs.values()))
    print(f"{'rss':16s} {tot:.3e}   (root-sum-square of one-hot stages)")

    ffts = ("fwd", "inv", "fwd2", "finale_fft")
    comp = ("input", "alpha", "had", "wsum", "finale_b2mul",
            "finale_assembly")
    for label, group in (
        ("ffts", ffts),       # floor of ANY product/sum-compensated pipeline
        ("nonfft", comp),     # what EFT compensation of products/sums buys
        ("all", ffts + comp),
    ):
        q = run(group)
        print(f"{label:16s} {np.abs(q - truth).max() / scale:.3e}   (group)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
