"""The Ozaki-scheme sliced contraction, standalone.

Demonstrates the core trick behind ``boltzfft.oz`` (the engine that runs the
f64-class collision pipeline's transforms as bf16 matrix products): a double-single
value splits into 7-bit mantissa chunks that are exactly representable in
bfloat16; chunk-pair dot products accumulate *exactly* in a 24-bit f32
accumulator (7 + 7 + log2(K) <= 24 bits for K <= 1024); and the handful of
slice-pair results recombine with compensated adds.  The matmul runs at
bf16 tensor-core speed while the result carries ~49 mantissa bits.

Run anywhere (CPU included):

    python examples/ozaki_contraction.py

Reference context: the CUDA operator links cuTensor but leaves the tensor
contraction as a TO-DO (``CUDABoltzmannOperator.cu:180-188``); this is that
direction completed, at beyond-hardware precision.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from boltzfft import ds, oz


def main():
    rng = np.random.default_rng(7)
    rows, k, ell = 256, 64, 64
    # wide per-row dynamic range — the regime where naive f32 loses digits
    x64 = (
        rng.standard_normal((rows, k)) * 10.0 ** rng.uniform(-6, 4, (rows, 1))
        + 1j * rng.standard_normal((rows, k)) * 10.0 ** rng.uniform(-6, 4, (rows, 1))
    )
    m64 = np.exp(1j * rng.uniform(0, 2 * np.pi, (k, ell))) / k
    ref = x64 @ m64
    scale = np.max(np.abs(ref))

    # plain f32: ~2^-24
    f32 = (x64.astype(np.complex64) @ m64.astype(np.complex64)).astype(complex)
    print(f"plain f32 matmul    rel err: {np.max(np.abs(f32 - ref))/scale:.3e}")

    # the sliced ds contraction: bf16-exact chunks, exact f32 accumulation,
    # compensated recombination -> ~2^-49
    x = ds.cds_from_f64(x64)
    msl = oz.slice_matrix(m64)
    out = oz.contract_last_oz(x, msl)
    got = ds.to_f64(out.re) + 1j * ds.to_f64(out.im)
    print(f"Ozaki ds contraction rel err: {np.max(np.abs(got - ref))/scale:.3e}")

    # show the decomposition on one value: chunks sum back to the ds pair
    sl = oz.slice_ds_last(x.re)
    rec = np.sum(np.asarray(sl, np.float64), axis=0)
    err = np.max(np.abs(rec - ds.to_f64(x.re)) / np.max(np.abs(x64.real), axis=-1, keepdims=True))
    print(f"chunk reconstruction (row-relative): {err:.3e}")
    print(f"chunks per value: {sl.shape[0]} x 7 bits, stored bf16")


if __name__ == "__main__":
    main()
