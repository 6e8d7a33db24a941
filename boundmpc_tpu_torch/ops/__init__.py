"""Hand-written CUDA kernels for the solver's hot linear algebra, each with its
plain PyTorch version beside it (see ``tsqr.py``)."""
from .tsqr import ls_solve, ls_solve_reference  # noqa: F401
