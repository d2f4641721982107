"""The Boltzmann collision operator as a pure, jittable JAX function.

Computes ``Q(f, f) = Q_gain - Q_loss`` for the spatially homogeneous Boltzmann
equation with a VHS kernel via the fast Fourier spectral method.  The whole
algorithm is three batched 3-D FFT passes plus fused elementwise work per
quadrature node, with a deterministic weighted reduction over nodes replacing
the reference's atomic accumulation (``FFTWBoltzmannOperator.cpp:267-270``,
``BoltzmannCUDAKernels.cu:120-121``) — run-to-run and device-count invariant by
construction.

Three implementations (selected by ``CollisionConfig.impl``):

* ``"c2c"`` — reference-faithful complex transforms; the direct analog of
  ``FFTWBoltzmannOperator::computeCollision`` (``FFTWBoltzmannOperator.cpp:147-334``)
  with jnp-normalized inverse FFTs absorbing the reference's ``fft_scale``
  bookkeeping (``FFTWBoltzmannOperator.cpp:162``).
* ``"rfft"`` — the fast path, exploiting a structural fact the reference leaves
  on the table (its own TO-DO at ``CUDABoltzmannOperator.cu:36``): for real
  ``f``, both shifted convolution factors

      g1 = IFFT(alpha1 . f_hat),   g2 = IFFT(conj(alpha1) . f_hat)

  are real (alpha1 is a pure phase with Hermitian symmetry, alpha1(-l) =
  conj(alpha1(l))), so every transform in the pipeline can be a real-to-complex
  half-spectrum FFT: ~2x less FLOPs and HBM traffic than the c2c pipeline.
  Exact caveat: the symmetry fails on the Nyquist planes, where ``irfftn``
  implicitly symmetrizes — a deviation bounded by f's Nyquist-mode content,
  i.e. below the spectral error floor for resolved distributions (verified to
  ~1e-13 relative against c2c on BKW data).
* ``"dft"`` — every per-node transform written as per-axis batched *real*
  matrix products (see ``_gain_chunk_dft``).

On a GPU every ``jnp.fft`` call lowers to a batched cuFFT plan — the
reference's ``cufftPlanMany`` over the quadrature batch — and XLA fuses the
elementwise stages around them.

The quadrature-node batch axis is processed in chunks with ``lax.scan`` so
device memory stays bounded at large ``Nv``/``Ns`` (the reference materializes five
``B * N^3`` work arrays, ``FFTWBoltzmannOperator.cpp:30-37`` — impossible at
Nv=64/Ns=32); accumulation across chunks is a carried sum over ``Q_gain_hat``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .weights import CollisionConfig, Precomp, build_precomp

_FFT_AXES = (-3, -2, -1)


def _alpha_factors(cfg: CollisionConfig, pre: Precomp, rho, sigma):
    """Separable per-axis phase factors of alpha1 for a chunk of nodes.

    alpha1(b, l) = exp(-i pi/(2L) rho_b (l . sigma_b))
                 = ax[b, lx] * ay[b, ly] * az[b, lz]
    (phases built on the fly exactly like ``FFTWBoltzmannOperator.cpp:204-214``,
    but factored per axis: 3 (C, N) tables instead of (C, N^3)).
    """
    coef = -np.pi / (2.0 * cfg.domain_length)
    cd = cfg.complex_dtype
    px = (coef * rho[:, None]) * (sigma[:, 0:1] * pre.lx[None, :])
    py = (coef * rho[:, None]) * (sigma[:, 1:2] * pre.ly[None, :])
    pz = (coef * rho[:, None]) * (sigma[:, 2:3] * pre.lz[None, :])
    ax = jnp.exp(1j * px.astype(cd))
    ay = jnp.exp(1j * py.astype(cd))
    az = jnp.exp(1j * pz.astype(cd))
    return ax, ay, az


def _beta1(cfg: CollisionConfig, pre: Precomp, rho):
    """Gain radial kernel beta1(b, l) = 4 pi b_gamma sincc(pi rho_b |l| / (2L)).

    (``FFTWBoltzmannOperator.cpp:261-262``; dtype-matched eps as in the
    templated device helper ``BoltzmannCUDAKernels.hpp:8-29``.)
    """
    eps = float(np.finfo(cfg.dtype).eps)
    arg = (np.pi / (2.0 * cfg.domain_length)) * rho[:, None, None, None] * pre.norm_l[None]
    return (4.0 * np.pi * cfg.b_gamma) * (jnp.sin(arg + eps) / (arg + eps))


def _gain_chunk_dft(cfg: CollisionConfig, pre: Precomp, f_hat, rho, sigma, gain_w):
    """Matrix-product path: the per-node transforms as batched einsums
    against shared per-axis DFT matrices — the completion of the reference's
    unfinished tensor-contraction direction (``CUDABoltzmannOperator.cu:180-188``).
    """
    ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)
    rd = cfg.real_dtype

    # All contractions are real-valued einsums over separate (re, im) planes.
    # The transform matrices are *shared* across nodes (the per-node phases
    # are applied as one fused elementwise multiply first), so each einsum is
    # one large matrix product rather than many small per-node ones.
    # Anisotropic grids use one matrix per axis (``Precomp.dft_*_axes``).
    inv_mats = pre.dft_inv_axes()
    fwd_mats = pre.dft_fwd_axes()

    def cmatmul(spec_str, mr, mi, tr, ti):
        """Complex contraction (mr + i mi) . (tr + i ti) via 3 real einsums
        (Karatsuba/Gauss trick: 25% fewer FLOPs than the naive 4), at
        ``cfg.dft_precision``."""
        es = partial(
            jnp.einsum, spec_str, preferred_element_type=rd,
            precision=cfg.dft_precision,
        )
        p1 = es(mr, tr)
        p2 = es(mi, ti)
        p3 = es(mr + mi, tr + ti)
        return p1 - p2, p3 - p1 - p2

    def mm3(mats, sr, si):
        # 3-axis tensor transform with per-axis (2, N, N) matrix stacks
        mx, my, mz = mats
        sr, si = cmatmul("xm,bmjk->bxjk", mx[0], mx[1], sr, si)
        sr, si = cmatmul("yn,bxnk->bxyk", my[0], my[1], sr, si)
        return cmatmul("zp,bxyp->bxyz", mz[0], mz[1], sr, si)

    # fused per-node phase multiply (same elementwise cost as the rfft path)
    a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
    a1f = a1 * f_hat[None]
    a2f = jnp.conj(a1) * f_hat[None]

    g1r, g1i = mm3(inv_mats, jnp.real(a1f).astype(rd), jnp.imag(a1f).astype(rd))
    g2r, g2i = mm3(inv_mats, jnp.real(a2f).astype(rd), jnp.imag(a2f).astype(rd))
    hr = g1r * g2r - g1i * g2i
    hi = g1r * g2i + g1i * g2r

    # shared forward transform (modes <- positions)
    hr, hi = mm3(fwd_mats, hr, hi)

    w = gain_w[:, None, None, None] * _beta1(cfg, pre, rho)
    qr = jnp.sum(w * hr, axis=0)
    qi = jnp.sum(w * hi, axis=0)
    return (qr + 1j * qi).astype(cfg.complex_dtype)


def _gain_chunk(cfg: CollisionConfig, pre: Precomp, f_hat, rho, sigma, gain_w):
    """Partial gain spectrum for one chunk of quadrature nodes.

    Returns sum_b gain_w[b] * beta1[b, l] * FFT(g1_b * g2_b)[l] for the chunk.
    """
    if cfg.impl == "dft":
        return _gain_chunk_dft(cfg, pre, f_hat, rho, sigma, gain_w)
    ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)
    # alpha1 * f_hat via broadcasted outer product (XLA fuses the broadcasts;
    # only the (C, modes) FFT input is materialized).
    a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
    a1f = a1 * f_hat[None]
    a2f = jnp.conj(a1) * f_hat[None]

    shape = cfg.grid_shape
    if cfg.impl == "rfft":
        g1 = jnp.fft.irfftn(a1f, s=shape, axes=_FFT_AXES)
        g2 = jnp.fft.irfftn(a2f, s=shape, axes=_FFT_AXES)
        h_hat = jnp.fft.rfftn(g1 * g2, axes=_FFT_AXES)
    else:
        g1 = jnp.fft.ifftn(a1f, axes=_FFT_AXES)
        g2 = jnp.fft.ifftn(a2f, axes=_FFT_AXES)
        h_hat = jnp.fft.fftn(g1 * g2, axes=_FFT_AXES)

    w = gain_w[:, None, None, None] * _beta1(cfg, pre, rho)
    return jnp.sum(w.astype(h_hat.dtype) * h_hat, axis=0)


def gain_spectrum(cfg: CollisionConfig, pre: Precomp, f_hat) -> jnp.ndarray:
    """Full gain spectrum Q_gain_hat, chunked over the node batch via scan.

    Chunking is derived from the *shape* of the node arrays in ``pre`` (not
    from ``cfg.n_nodes``) so the same code runs on a device-local shard of the
    node axis inside ``shard_map``.
    """
    b = pre.rho.shape[0]
    c = min(cfg.chunk, b)
    if b % c != 0:
        # Caller supplied a node count the configured chunk doesn't divide
        # (e.g. a hand-built unpadded Precomp): round down to the largest
        # divisor of b so chunking still bounds the working set — one
        # whole-batch chunk could OOM at large Nv/Ns.
        while b % c:
            c -= 1
    n_chunks = b // c
    if n_chunks == 1:
        return _gain_chunk(cfg, pre, f_hat, pre.rho, pre.sigma, pre.gain_w)

    rho = pre.rho.reshape(n_chunks, c)
    sigma = pre.sigma.reshape(n_chunks, c, 3)
    gain_w = pre.gain_w.reshape(n_chunks, c)

    def body(acc, chunk):
        r, s, w = chunk
        return acc + _gain_chunk(cfg, pre, f_hat, r, s, w), None

    # Seed the carry with chunk 0 (not zeros) so its shard_map varying-axis
    # type matches the chunk results when the node axis is device-sharded.
    init = _gain_chunk(cfg, pre, f_hat, rho[0], sigma[0], gain_w[0])
    acc, _ = jax.lax.scan(
        body, init, (rho[1:], sigma[1:], gain_w[1:])
    )
    return acc


def collide(
    cfg: CollisionConfig,
    pre: Precomp,
    f: jnp.ndarray,
    gain_reduce: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> jnp.ndarray:
    """Evaluate Q(f, f) on the velocity grid.  Pure and jittable.

    Pipeline (reference: ``FFTWBoltzmannOperator.cpp:147-334``, normalization
    mapped to jnp's 1/N-normalized inverse transforms):

      1. ``f_hat = FFT(f)``
      2. per node: ``g1 = IFFT(alpha1 f_hat)``, ``g2 = IFFT(conj(alpha1) f_hat)``,
         ``h_hat = FFT(g1 g2)``
      3. ``Q_gain = Re IFFT( sum_b w_b beta1_b h_hat_b )``  (deterministic einsum,
         not atomics)
      4. ``Q_loss = Re IFFT(beta2 f_hat) * f``
      5. ``Q = Q_gain - Q_loss``

    ``gain_reduce`` is an optional hook applied to the gain spectrum before the
    final inverse transform — the sharded operator passes ``psum`` over the
    node-axis mesh dimension here (see ``boltzfft.sharding``).
    """
    f = f.astype(cfg.real_dtype)
    shape = cfg.grid_shape
    if cfg.impl == "rfft":
        f_hat = jnp.fft.rfftn(f, axes=_FFT_AXES)
        q_gain_hat = gain_spectrum(cfg, pre, f_hat)
        if gain_reduce is not None:
            q_gain_hat = gain_reduce(q_gain_hat)
        q_gain = jnp.fft.irfftn(q_gain_hat, s=shape, axes=_FFT_AXES)
        loss_conv = jnp.fft.irfftn(
            pre.beta2.astype(f_hat.dtype) * f_hat, s=shape, axes=_FFT_AXES
        )
    else:  # "c2c" and "dft": full complex spectrum pipeline
        f_hat = jnp.fft.fftn(f.astype(cfg.complex_dtype), axes=_FFT_AXES)
        q_gain_hat = gain_spectrum(cfg, pre, f_hat)
        if gain_reduce is not None:
            q_gain_hat = gain_reduce(q_gain_hat)
        q_gain = jnp.fft.ifftn(q_gain_hat, axes=_FFT_AXES).real
        loss_conv = jnp.fft.ifftn(
            pre.beta2.astype(f_hat.dtype) * f_hat, axes=_FFT_AXES
        ).real
    return q_gain - loss_conv * f


def make_collision_operator(
    cfg: CollisionConfig, jit: bool = True
) -> Tuple[Callable[[jnp.ndarray, Precomp], jnp.ndarray], Precomp]:
    """Build ``(collide_fn, precomp)`` for a configuration.

    ``collide_fn(f, precomp) -> Q`` is the entire collision operator as one
    (optionally jitted) pure function — the replacement for the reference's
    ``AbstractCollisionOperator`` hierarchy
    (``AbstractCollisionOperator.hpp:7-26``): backends collapse into XLA, state
    into the ``Precomp`` pytree.
    """
    pre = build_precomp(cfg)
    fn = partial(collide, cfg)

    def collide_fn(f, precomp):
        return fn(precomp, f)

    if jit:
        collide_fn = jax.jit(collide_fn)
    return collide_fn, pre
