"""Global-solver planning backend (the JAX package's `solve/`).

A second planning engine: pod x node placement lowered to a batched
assignment relaxation over every candidate node count at once (K22/K23),
so the capacity search becomes ONE solve instead of doubling + bisection
over full placements. Always advisory: the solver proposes a candidate
placement, the auditor (`audit/`) disposes — audit-dirty answers fall back
to the serial exact engine, and nothing uncertified ever ships.
"""

from .planner import (  # noqa: F401
    SOLVE_COUNT_KEYS,
    SolveAttempt,
    attempt_solve,
    solve_capacity_plan,
    solve_counts,
    solve_lower_bound,
)
from .relax import build_relax_problem, relax_candidates  # noqa: F401
from .rounding import nodes_from_counts, round_candidate  # noqa: F401
