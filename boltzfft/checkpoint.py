"""Orbax-backed checkpoint/resume for long relaxation runs.

The reference's only persisted artifact is the FFTW wisdom file (plan cache,
``FFTWBoltzmannOperator.cpp:60-68``) — state checkpointing does not exist
there (SURVEY.md section 6).  For production ensemble relaxations (hours of
wall clock, preemptible accelerator capacity) this module persists the full solver
state — distribution ``f`` (arbitrary sharding, incl. multi-host: orbax
writes each shard from its owning process), simulation time, and step
counter — with atomic directory commits and retention.

    ck = RelaxCheckpointer(dir, max_to_keep=3)
    step = ck.latest_step()
    if step is not None:
        f, t = ck.restore(step, template=f)     # template carries sharding
    ...
    ck.save(step, f, t)
    ck.close()
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Tuple


class RelaxCheckpointer:
    """Thin, typed wrapper around ``orbax.checkpoint.CheckpointManager``.

    State layout: ``{"f": Array, "t": float, "extra": pytree|None}`` saved
    under integer step numbers.
    """

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self._mngr = ocp.CheckpointManager(
            Path(directory).expanduser().resolve(),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def latest_step(self) -> Optional[int]:
        return self._mngr.latest_step()

    def save(self, step: int, f, t: float, extra: Any = None) -> None:
        state = {"f": f, "t": float(t)}
        if extra is not None:
            state["extra"] = extra
        self._mngr.save(step, args=self._ocp.args.StandardSave(state))

    def restore(
        self, step: Optional[int] = None, template=None, extra_template: Any = None
    ) -> Tuple[Any, float]:
        """Restore ``(f, t)`` (or ``(f, t, extra)`` when ``extra_template``
        is given).  ``template`` (an array or abstract array with the target
        sharding) makes orbax place shards directly on the right devices."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        args = None
        if template is not None:
            state = {"f": template, "t": 0.0}
            if extra_template is not None:
                state["extra"] = extra_template
            args = self._ocp.args.StandardRestore(state)
        restored = self._mngr.restore(step, args=args)
        if extra_template is not None:
            return restored["f"], float(restored["t"]), restored["extra"]
        return restored["f"], float(restored["t"])

    def wait(self) -> None:
        """Block until any async save has committed."""
        self._mngr.wait_until_finished()

    def close(self) -> None:
        self._mngr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
