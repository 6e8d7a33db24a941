"""Host runtime: scenario construction and fleet building."""
from .scenarios import (Scenario, default_weights, experiment1,  # noqa: F401
                        experiment2, random_scenario)
from .fleet import build_fleet, fleet_tensors  # noqa: F401
