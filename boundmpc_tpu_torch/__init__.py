"""boundmpc_tpu_torch — the PyTorch / CUDA port of ``boundmpc_tpu``.

Cartesian path-following MPC for a 7-DOF manipulator, batched over fleets of
scenarios: kinematics, Lie-space path errors, quartic bound envelopes, the
condensed OCP, the relaxed-barrier Gauss-Newton solver (its least-squares
step a hand-written Hopper kernel, ``ops/tsqr.py``), the receding-horizon
engine, the stream executor, the serving entry points: ``FleetRunner``
and ``ClosedLoopRunner`` (``runtime``) and the reference-compatible
``api.BoundMPC``, the scenario-sharded fleet over ``torch.distributed``
(``distributed``, one process per card), the offline report
(``observability``) and the command lines (``experiments``).  The JAX package stays the reference; this package imports
torch and never jax.
"""

__version__ = "0.1.0"

from . import lie, kinematics, jerkint, bounds, path, ocp, jacobian  # noqa: F401
from . import solver, engine, batch, stream, convert  # noqa: F401
from . import runtime, api  # noqa: F401
