"""Multi-process (multi-host) runtime initialization and mesh layout.

The reference is strictly single-node (``slurm_run_maxwell_bkw_fftw.sb:8-9``:
``--nodes=1 --ntasks=1``); its only scaling axis is OpenMP threads.  Here a
run can span hosts: each process owns its local GPUs, ``jax.distributed``
wires the processes into one runtime, and the same ``shard_map`` program from
:mod:`boltzfft.sharding` runs over the global device set — node-axis ``psum``
traffic stays on the NVLink within a host, only ensemble (no-communication)
axes should cross the inter-node network.

Usage on each process::

    import boltzfft as bz
    bz.initialize_distributed("host0:1234", num_processes=2, process_id=0)
    mesh = bz.make_multihost_mesh(ensemble_hosts=True)
    collide_fn, pre = bz.make_sharded_collision_operator(cfg, mesh, ...)

Design rule encoded in :func:`make_multihost_mesh`: the quadrature-node axis
(one psum per eval) must never span processes unless explicitly requested —
crossing the inter-node network with the gain reduction turns an NVLink
collective into a network round trip per eval.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .sharding import ENSEMBLE_AXIS, NODE_AXIS


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Initialize the multi-process JAX runtime (idempotent).

    The coordinator comes from ``coordinator_address`` or the
    ``JAX_COORDINATOR_ADDRESS`` environment variable (with
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` for the other two).  Returns
    ``True`` if a multi-process runtime is active after the call, ``False``
    for the single-process case (no coordinator configured) — single-process
    operation is never an error, so the same driver script runs unmodified
    on one GPU or many hosts.
    """
    import jax

    try:  # already initialized (idempotent re-entry)?
        from jax._src.distributed import global_state

        if global_state.client is not None:
            return jax.process_count() > 1
    except ImportError:  # private API moved: fall through, initialize() will
        pass  # raise its own "already initialized" error if needed
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None:
        return False  # plain single-process run
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        # Backend already initialized (e.g. a driver touched jax.devices()
        # first, or a test harness owns the backend): degrade to whatever
        # process topology is already active rather than crashing the run.
        if "before any JAX calls" not in str(e):
            raise
        import warnings

        warnings.warn(
            "jax.distributed.initialize skipped: the XLA backend was already "
            "initialized; running with the existing process topology",
            RuntimeWarning,
            stacklevel=2,
        )
    return jax.process_count() > 1


def make_multihost_mesh(
    node_devices_per_host: Optional[int] = None,
    ensemble_hosts: bool = True,
):
    """2-D ``(ensemble, node)`` mesh laid out so the node axis stays within a
    host (psum over NVLink) and the ensemble axis spans hosts (the
    inter-node network sees no per-eval traffic).

    * ``node_devices_per_host``: node-axis span per host (default: all local
      devices of each host).
    * ``ensemble_hosts=False`` asserts the run is node-only across hosts: it
      rejects multi-process topologies whose node psum would cross hosts.  On a
      single process it is purely an assertion — the mesh is still 2-D, with
      ensemble size ``len(devices) // node_size`` (1 when ``node_size`` spans
      all devices); pass ``node_devices_per_host=len(jax.devices())`` for a
      node-only 1-wide-ensemble mesh.

    On one process this degenerates to the single-host 2-D mesh from
    :func:`boltzfft.make_mesh`.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devices) // n_hosts
    node_size = node_devices_per_host or per_host
    if per_host % node_size:
        raise ValueError(
            f"node_devices_per_host={node_size} must divide the {per_host} "
            "devices each host owns"
        )
    ens_size = len(devices) // node_size
    if not ensemble_hosts and n_hosts > 1:
        raise ValueError(
            "ensemble_hosts=False with multiple processes would run the "
            "node-axis psum across hosts; pass node_devices_per_host explicitly "
            "if that is really intended"
        )
    # Sort devices host-major so contiguous node groups are host-local.
    dev_sorted = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.asarray(dev_sorted).reshape(ens_size, node_size)
    return Mesh(arr, (ENSEMBLE_AXIS, NODE_AXIS))


def process_local_ensemble_slice(total: int) -> Tuple[int, int]:
    """(start, size) of this process's block of a ``total``-member ensemble,
    for building per-host input shards of a globally sharded array."""
    import jax

    n, rank = jax.process_count(), jax.process_index()
    if total % n:
        raise ValueError(f"ensemble size {total} must divide over {n} processes")
    size = total // n
    return rank * size, size
