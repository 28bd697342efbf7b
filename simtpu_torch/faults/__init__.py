"""Fault injection & resilience: batched failure-scenario sweeps.

The port of the JAX package's `simtpu/faults`: a failure scenario is a
boolean node mask, a drain is a batch of signed placement-log deltas, a
requeue is one more placement over the masked cluster — and the whole
scenario axis evaluates as the grid of K18/K19 (faults/sweep.py), the
same batching move as the capacity sweep (parallel/sweep.py).
`plan.resilience.plan_resilience` wraps it in an N+k survivability search.
"""

from .drain import (
    DrainResult,
    PlacedCluster,
    drain_requeue,
    drain_simulator,
    place_cluster,
)
from .scenarios import (
    DOMAIN_KEYS,
    ScenarioSet,
    domain_scenarios,
    generate_scenarios,
    k_node_scenarios,
    parse_fault_spec,
    single_node_scenarios,
    stack_scenarios,
)
from .sweep import SweepResult, serial_replay, sweep_scenarios

__all__ = [
    "DOMAIN_KEYS",
    "DrainResult",
    "PlacedCluster",
    "ScenarioSet",
    "SweepResult",
    "domain_scenarios",
    "drain_requeue",
    "drain_simulator",
    "generate_scenarios",
    "k_node_scenarios",
    "parse_fault_spec",
    "place_cluster",
    "serial_replay",
    "single_node_scenarios",
    "stack_scenarios",
    "sweep_scenarios",
]
