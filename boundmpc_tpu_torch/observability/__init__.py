"""Observability: horizon-wise rotation-error diagnostics (``horizon``).

The JAX package's figure report (``observability/report.py``) is not ported
yet."""
from .horizon import horizon_plane_errors, make_horizon_eval  # noqa: F401
