"""The one place that picks a pipeline for the backend JAX runs on.

Every caller that needs "the pipeline for this machine" — the CLI's
``--impl auto``, the self-check, the benchmark, the driver entry points and
the compensated (ds) pipeline's transform engine — asks
:func:`pipeline_choice`.  A backend missing from the table is an error, not a
silent default.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class PipelineChoice(NamedTuple):
    """Pipeline defaults for one backend."""

    impl: str  # CollisionConfig.impl of the staged operator
    ds_contract: str  # collide_ds transform engine ("vpu" or "oz")


# The staged transforms are XLA FFTs on every backend (cuFFT on a GPU), and
# the half-spectrum rfft pipeline moves half the bytes of c2c.  The ds engine
# is the compensated rank-1 "vpu" contraction: on the CPU the "oz" engine's
# bfloat16 products are emulated, and on the GPU its thousands of small
# matrix products take minutes to compile (see PERF.md).
_CHOICES = {
    "cpu": PipelineChoice(impl="rfft", ds_contract="vpu"),
    "gpu": PipelineChoice(impl="rfft", ds_contract="vpu"),
}


def pipeline_choice(backend: Optional[str] = None) -> PipelineChoice:
    """Pipeline defaults for ``backend`` (default: ``jax.default_backend()``).

    Raises ``ValueError`` for a backend this package has no choice for.
    """
    if backend is None:
        import jax

        backend = jax.default_backend()
    try:
        return _CHOICES[backend]
    except KeyError:
        raise ValueError(
            f"no pipeline choice for backend {backend!r}; supported: "
            f"{sorted(_CHOICES)}"
        ) from None
