"""Parity harness: independent golden solvers for the BoundMPC OCP (port of
``boundmpc_tpu/parity``).

``OracleSolver`` is scipy's SLSQP in float64 on the same condensed NLP as
the Gauss-Newton solver; ``RefNlpSolver`` rebuilds the NLP the way the
reference writes it (440 stage variables, 36 dynamics equalities per
stage), the one check independent of the condensed formulation.  Both
evaluate the NLP in float64 on the device they are built on and plug into
``engine.tick`` as its ``solve_fn``; ``oracle_runner`` / ``ref_nlp_runner``
are ``ClosedLoopRunner``s driven by them.
"""
from .oracle import OracleSolver, oracle_runner  # noqa: F401
from .ref_nlp import RefNlpSolver, ref_nlp_runner  # noqa: F401
