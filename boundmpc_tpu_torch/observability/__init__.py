"""Observability: the figure report of a closed-loop log (``report``),
horizon-wise rotation-error diagnostics (``horizon``) and the executors'
call records and spans (``spans``, imported by the executors themselves).

The report replaces the reference's Logger -> Plotter pipeline: the npz
export and figures are rendered to files from logged telemetry.  matplotlib
is imported only when figures are rendered.
"""
from .horizon import horizon_plane_errors, make_horizon_eval  # noqa: F401
from .report import Report, generate_report  # noqa: F401
