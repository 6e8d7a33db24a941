"""The plain reference of the benchmark's ``correct``.

A frozen copy of the port's per-lane numerics (path and bounds set-up, Lie
algebra, kinematics, jerk integration, the OCP's residuals and constraints,
the Jacobians, the Gauss-Newton solver and the engine's tick halves), in
plain ``torch`` with the least-squares step by ``torch.linalg.qr``
(``solver.ls_solve``).  It imports nothing of the program and takes nothing
the program made: the harness builds its paths, prefactors and weights from
the traffic's data, and converts the program's carried state to float64
before a tick.  The harness runs it in float64 as the reference, and in
float32 with its matmuls under bfloat16 autocast as the control
(``tick.precision``).
"""
