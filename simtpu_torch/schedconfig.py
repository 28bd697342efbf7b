"""KubeSchedulerConfiguration consumption.

The reference accepts `--default-scheduler-config` and merges the file into
its in-memory scheduler profile before force-enabling the Simon/Open-Local/
Open-Gpu-Share plugins (`pkg/simulator/utils.go:212-289`). The practically
configurable surface of that file is the score-plugin set: which plugins run
and with what weight. This module lowers that surface onto the engine's
score-term weight vector (`scan.StaticArrays.score_w`).

Filter plugins are hard constraints in this engine and cannot be disabled
(matching the reference, which never disables filters either — it only
appends to them).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# score-term order in StaticArrays.score_w — must match scan.schedule_step
TERM_LEAST = 0  # NodeResourcesLeastAllocated
TERM_BALANCED = 1  # NodeResourcesBalancedAllocation
TERM_SIMON = 2  # Simon (dominant share)
TERM_GPU = 3  # Open-Gpu-Share (same formula as Simon)
TERM_NODE_PREF = 4  # NodeAffinity (preferred)
TERM_TAINT = 5  # TaintToleration
TERM_IPA = 6  # InterPodAffinity
TERM_SPREAD_SOFT = 7  # PodTopologySpread (ScheduleAnyway)
TERM_SS = 8  # SelectorSpread
TERM_IMAGE = 9  # ImageLocality
TERM_OPEN_LOCAL = 10  # Open-Local binpack
TERM_AVOID = 11  # NodePreferAvoidPods (penalty form; registry weight folded in)
N_TERMS = 12

#: default-provider weights (`vendor/.../algorithmprovider/registry.go:101-145`
#: — PodTopologySpread carries weight 2; NodePreferAvoidPods' 10000 is folded
#: into its penalty term, so its weight here stays 1)
DEFAULT_WEIGHTS = np.array(
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 1.0, 1.0, 1.0, 1.0], np.float32
)


@dataclass
class SchedulerConfig:
    """Score-weight view of a KubeSchedulerConfiguration (the port takes
    the weights directly; parsing the file comes with the `apply` front
    door, ROADMAP queue 1)."""

    score_weights: np.ndarray = field(
        default_factory=lambda: DEFAULT_WEIGHTS.copy()
    )
