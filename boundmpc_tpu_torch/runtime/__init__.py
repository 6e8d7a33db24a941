"""Host runtime: scenario construction, the closed-loop runner, the fleet
runner and MPCData telemetry.

The JAX package's ``enable_compilation_cache`` has no counterpart: it sets
XLA's persistent compilation cache, and the port compiles nothing but its
kernels, which ``ops/_build.py`` caches by source hash.
"""
from .scenarios import (Scenario, default_path, default_weights,  # noqa: F401
                        experiment1, experiment2, random_scenario)
from .runner import ClosedLoopRunner, RunLog  # noqa: F401
from .fleet import (FleetRunner, FleetStats, build_fleet, fleet_scenarios,  # noqa: F401
                    fleet_tensors)
