"""Multi-chip scaling: mesh construction and sharded collision operators.

The reference is single-node/single-device — its only scaling mechanism is
OpenMP threads over the quadrature-node batch (``FFTWBoltzmannOperator.cpp:191-193``).
The equivalents here (SURVEY.md section 3, parallelism inventory):

* **Node-axis sharding** ("tensor parallel" analog): the quadrature batch
  ``b = (r, s)`` is embarrassingly parallel except for the final gain
  reduction; each device evaluates its node shard against a replicated ``f``
  and a single ``psum`` combines partial gain spectra.  FFTs remain
  shard-local (the sharded axis is never an FFT axis) — no distributed FFT.
* **Ensemble sharding** ("data parallel" analog): independent distributions
  (e.g. spatial cells of a 0D-3V ensemble) spread across devices with no
  communication at all.

Both compose on one 2-D mesh ``(ensemble, node)``.  Padded quadrature entries
carry zero gain weight, so uneven node counts shard cleanly.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .operator import collide
from .weights import CollisionConfig, Precomp, build_precomp, repad_nodes

ENSEMBLE_AXIS = "ensemble"
NODE_AXIS = "node"


def make_mesh(
    axis_sizes: Sequence[Tuple[str, int]] | None = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over available devices.

    ``axis_sizes`` is an ordered list of ``(name, size)``; defaults to all
    devices on a 1-D node axis.  Example:
    ``make_mesh([("ensemble", 2), ("node", 4)])`` on 8 chips.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if axis_sizes is None:
        axis_sizes = [(NODE_AXIS, len(devices))]
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(s for _, s in axis_sizes)
    n_req = int(np.prod(shape))
    if n_req > len(devices):
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n_req} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n_req]).reshape(shape)
    return Mesh(dev_array, names)


def _node_sharded_precomp(cfg: CollisionConfig, n_shards: int) -> Precomp:
    """Precomp whose node axis divides evenly into ``n_shards`` x chunks."""
    pre = build_precomp(cfg)
    local = -(-cfg.n_nodes // n_shards)
    if cfg.node_chunk is not None:
        c = cfg.chunk
        local = -(-local // c) * c
    return repad_nodes(pre, n_shards * local)


def _precomp_specs(node_axis: Optional[str], pre: Precomp) -> Precomp:
    """PartitionSpecs for each Precomp leaf (node arrays sharded, rest
    replicated); optional fields mirror ``pre``'s presence."""
    rep3 = P(None, None, None)
    return Precomp(
        rho=P(node_axis),
        sigma=P(node_axis, None),
        gain_w=P(node_axis),
        lx=P(None),
        ly=P(None),
        lz=P(None),
        norm_l=rep3,
        beta2=rep3,
        **{
            name: None if getattr(pre, name) is None else rep3
            for name in ("dft_fwd", "dft_inv", "dft_fwd_y", "dft_inv_y",
                         "dft_fwd_z", "dft_inv_z")
        },
    )


def make_sharded_collision_operator(
    cfg: CollisionConfig,
    mesh: Mesh,
    node_axis: Optional[str] = NODE_AXIS,
    ensemble_axis: Optional[str] = None,
    jit: bool = True,
) -> Tuple[Callable[[jnp.ndarray, Precomp], jnp.ndarray], Precomp]:
    """Build a ``shard_map``-sharded collision operator over ``mesh``.

    * ``node_axis`` (optional): mesh axis sharding the quadrature-node batch;
      the gain reduction becomes a single ``psum`` over that axis.
    * ``ensemble_axis`` (optional): mesh axis sharding a leading ensemble
      dimension of ``f`` (shape ``(E, N, N, N)``); no communication.

    Returns ``(collide_fn, precomp)``; the node arrays of ``precomp`` are
    padded to shard evenly.  Place ``precomp``/``f`` with matching shardings
    for zero-copy dispatch (or let jit insert the transfers).
    """
    if node_axis is None and ensemble_axis is None:
        raise ValueError("need at least one of node_axis/ensemble_axis")
    n_node_shards = mesh.shape[node_axis] if node_axis else 1
    pre = _node_sharded_precomp(cfg, n_node_shards)

    reduce_fn = (
        (lambda x: jax.lax.psum(x, node_axis)) if node_axis and n_node_shards > 1 else None
    )
    local_collide = partial(collide, cfg)

    def body(f, p):
        one = lambda fi: local_collide(p, fi, gain_reduce=reduce_fn)
        if ensemble_axis is not None:
            return jax.vmap(one)(f)
        return one(f)

    f_spec = P(ensemble_axis) if ensemble_axis is not None else P()
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(f_spec, _precomp_specs(node_axis, pre)),
        out_specs=f_spec,
        # the node-axis psum placement is explicit in `body`.
        check_vma=False,
    )

    def collide_fn(f, precomp):
        return sharded(f, precomp)

    if jit:
        collide_fn = jax.jit(collide_fn)
    return collide_fn, pre


def place(
    pre: Precomp, mesh: Mesh, node_axis: Optional[str] = NODE_AXIS
) -> Precomp:
    """Device-put Precomp leaves with their intended shardings (avoids a
    resharding transfer on first call)."""
    specs = _precomp_specs(node_axis, pre)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        pre,
        specs,
    )


def place_cells(
    f,
    mesh: Mesh,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    z_axis: Optional[str] = None,
):
    """Device-put a spatially-decomposed distribution with its leading cell
    axes sharded over mesh axes — the spatial domain decomposition for the
    1D/2D/3D transport solvers.

    ``f`` is ``(Cx, Nvx, Nvy, Nvz)`` (1D), ``(Cx, Cy, Nvx, Nvy, Nvz)``
    (2D), or ``(Cx, Cy, Cz, Nvx, Nvy, Nvz)`` (3D); ``x_axis``/``y_axis``/
    ``z_axis`` name the mesh axes the spatial cell axes shard over (None =
    replicate that axis).  The velocity axes are always shard-local — an
    FFT axis is never sharded (SURVEY §6).

    No solver changes are needed downstream: under ``jit`` XLA's SPMD
    partitioner lowers the advection stencils' ``jnp.roll`` halo exchanges
    (:func:`boltzfft.transport._advect_muscl_axis`) to nearest-neighbor
    ``collective-permute`` ops over the mesh, and the collision substep — batched over cells — runs
    shard-local with zero cross-cell traffic.  Asserted by
    ``tests/test_transport.py::TestSpatialSharding`` (sharded-vs-unsharded
    parity + halo collectives present in the compiled module).  The
    reference has no spatial solver at all; this is a boltzfft extension.
    """
    n_cell_axes = f.ndim - 3
    if n_cell_axes not in (1, 2, 3):
        raise ValueError(
            f"expected (Cx[, Cy[, Cz]], Nvx, Nvy, Nvz), got {f.ndim}-d input"
        )
    names = (x_axis, y_axis, z_axis)[:n_cell_axes]
    spec = P(*names)
    return jax.device_put(f, jax.sharding.NamedSharding(mesh, spec))
