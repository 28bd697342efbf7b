"""Decision observability: *why* did the scheduler do what it did.

The port of the JAX package's `explain/`. The engine compresses every
failure into ONE coarse code (the first mask stage that emptied the
candidate set); this package rebuilds the full per-node story:

- `breakdown` — every unplaced pod's whole filter cascade re-evaluated
  against a carried state (K20 `explain_pass`, one launch per chunk of 64
  pods on the card): per-pod x per-stage node-elimination counts, capped
  per-node witnesses, and the exact kube-scheduler-style status string;
- `scores` — per-plugin decomposition of a placed pod's winning score,
  with the runner-up node and margin (K21 `pod_terms`);
- `bottleneck` — binding-constraint analysis over an unplaced set: which
  resource (or constraint class) binds, whether another template node can
  ever help, and a what-to-buy hint (host numpy).

Surfaces: `simulate(explain=...)`, the planners' `explain=`, `--explain`
on `apply` / `resilience`, the `explain` subcommand, the versioned
`explain` block in `--json` and `report.explain_report`. Nothing here is
imported or launched unless an explanation was requested.
"""

from .bottleneck import bottleneck_analysis
from .breakdown import (
    EXPLAIN_VERSION,
    STAGES,
    FailureBreakdown,
    build_explain_doc,
    explain_failures,
)
from .scores import attribute_scores, extras_from_log

__all__ = [
    "EXPLAIN_VERSION",
    "STAGES",
    "FailureBreakdown",
    "attribute_scores",
    "bottleneck_analysis",
    "build_explain_doc",
    "explain_failures",
    "extras_from_log",
]
