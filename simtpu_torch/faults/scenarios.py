"""Failure-scenario model: deterministic, seed-driven what-if outages.

The reference answers only static questions — "does this app list fit" and
"min nodes to fit" (`pkg/apply/apply.go:183-233`); it has no notion of a
node dying.  This module makes a failure scenario a first-class VALUE: a
boolean node mask (True = node failed), stackable into a `[S, N]` scenario
tensor that the batched sweep (faults/sweep.py) evaluates as one more
vmapped axis — the same move that turned the candidate-size loop into the
capacity sweep (parallel/sweep.py).

Three generators cover the outage families capacity reviews actually ask
about:

- `single_node_scenarios`: exhaustive one-node failures (the N+1 question);
- `k_node_scenarios`: k-node combinations — exhaustive while C(n, k) fits
  the sample budget, else sampled WITHOUT replacement from a seeded
  Generator (deterministic for a given (n, k, samples, seed));
- `domain_scenarios`: correlated outages keyed off node labels (zone, rack
  — `synth_cluster` stamps both), one scenario per distinct domain value.

Everything is host-side numpy: a copy of the JAX package's
`faults/scenarios.py`, so the seeded sampling gives the same masks.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .. import constants as C

#: spec shorthand → node-label key for domain outages
DOMAIN_KEYS = {
    "zone": C.LABEL_ZONE,
    "rack": C.LABEL_RACK,
    "host": C.LABEL_HOSTNAME,
}


@dataclass(frozen=True)
class ScenarioSet:
    """A batch of failure scenarios over one cluster.

    masks:  [S, N] bool — True marks a FAILED node in that scenario.  The
            complement of a scenario row is the surviving cluster's
            node_valid mask.
    labels: [S] human-readable scenario names ("node:node-000003",
            "k=2:17", "zone:zone-4").
    kind:   generator family ("single" | "k" | "domain" | "mixed").
    k:      failure size (nodes per scenario; max across rows for domain
            outages, whose domains need not be equal-sized).
    """

    masks: np.ndarray
    labels: tuple
    kind: str = "mixed"
    k: int = 1

    def __len__(self) -> int:
        return int(self.masks.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.masks.shape[1])


def stack_scenarios(sets: Sequence[ScenarioSet]) -> ScenarioSet:
    """Concatenate scenario sets over one cluster into a single sweepable
    batch (the scenario axis is just rows — kinds may mix freely)."""
    sets = [s for s in sets if len(s)]
    if not sets:
        raise ValueError("no scenarios to stack")
    n = {s.n_nodes for s in sets}
    if len(n) != 1:
        raise ValueError(f"scenario sets span different clusters: {sorted(n)}")
    kinds = {s.kind for s in sets}
    return ScenarioSet(
        masks=np.concatenate([s.masks for s in sets], axis=0),
        labels=tuple(lbl for s in sets for lbl in s.labels),
        kind=kinds.pop() if len(kinds) == 1 else "mixed",
        k=max(s.k for s in sets),
    )


def _candidates(n_nodes: int, valid: Optional[np.ndarray]) -> np.ndarray:
    if valid is None:
        return np.arange(n_nodes)
    valid = np.asarray(valid, bool)
    if valid.shape != (n_nodes,):
        raise ValueError(f"valid mask shape {valid.shape} != ({n_nodes},)")
    return np.flatnonzero(valid)


def _node_name(nodes, i: int) -> str:
    if nodes is None:
        return f"node[{i}]"
    meta = nodes[i].get("metadata") or {}
    return meta.get("name") or f"node[{i}]"


def single_node_scenarios(
    n_nodes: int,
    nodes: Optional[List[dict]] = None,
    valid: Optional[np.ndarray] = None,
) -> ScenarioSet:
    """Exhaustive single-node failures over the (valid) nodes — the
    N+1 survivability question."""
    cand = _candidates(n_nodes, valid)
    masks = np.zeros((len(cand), n_nodes), bool)
    masks[np.arange(len(cand)), cand] = True
    labels = tuple(f"node:{_node_name(nodes, int(i))}" for i in cand)
    return ScenarioSet(masks=masks, labels=labels, kind="single", k=1)


def k_node_scenarios(
    n_nodes: int,
    k: int,
    samples: int = 256,
    seed: int = 0,
    valid: Optional[np.ndarray] = None,
) -> ScenarioSet:
    """k-node failure combinations: exhaustive while C(n, k) <= samples
    (lexicographic order), else `samples` DISTINCT combinations sampled from
    a seeded Generator — deterministic for a given (n, k, samples, seed),
    independent of process or platform."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    cand = _candidates(n_nodes, valid)
    if k > len(cand):
        raise ValueError(f"k={k} exceeds the {len(cand)} failable nodes")
    if k == 1:
        # exhaustive single-node failures regardless of the sample budget:
        # N scenarios is the floor any N+1 answer needs anyway
        return single_node_scenarios(n_nodes, valid=valid)
    total = math.comb(len(cand), k)
    if samples <= 0 or total <= samples:
        combos = [cand[list(c)] for c in itertools.combinations(range(len(cand)), k)]
    else:
        rng = np.random.default_rng(seed)
        seen, combos = set(), []
        # distinct k-subsets; the attempt cap bounds the (astronomically
        # unlikely) degenerate tail when samples approaches C(n, k)
        attempts = 0
        while len(combos) < samples and attempts < 50 * samples:
            attempts += 1
            pick = tuple(sorted(rng.choice(len(cand), size=k, replace=False).tolist()))
            if pick in seen:
                continue
            seen.add(pick)
            combos.append(cand[list(pick)])
    masks = np.zeros((len(combos), n_nodes), bool)
    for s, nodes_idx in enumerate(combos):
        masks[s, nodes_idx] = True
    labels = tuple(f"k={k}:{s}" for s in range(len(combos)))
    return ScenarioSet(masks=masks, labels=labels, kind="k", k=k)


def domain_scenarios(
    nodes: List[dict],
    label_key: str,
    valid: Optional[np.ndarray] = None,
) -> ScenarioSet:
    """One scenario per distinct value of `label_key` among the (valid)
    nodes: the whole failure domain goes down at once (zone outage, rack
    power loss).  Nodes without the label belong to no domain and never
    fail here."""
    n = len(nodes)
    cand = set(_candidates(n, valid).tolist())
    by_value: dict = {}
    for i, node in enumerate(nodes):
        if i not in cand:
            continue
        labels = (node.get("metadata") or {}).get("labels") or {}
        value = labels.get(label_key)
        if value is not None:
            by_value.setdefault(value, []).append(i)
    values = sorted(by_value)
    masks = np.zeros((len(values), n), bool)
    for s, value in enumerate(values):
        masks[s, by_value[value]] = True
    short = label_key.rsplit("/", 1)[-1]
    labels_out = tuple(f"{short}:{v}" for v in values)
    k = max((len(v) for v in by_value.values()), default=0)
    return ScenarioSet(masks=masks, labels=labels_out, kind="domain", k=k)


def parse_fault_spec(spec: str) -> List[dict]:
    """Parse the CLI fault spec: comma-separated terms of

    - ``k=<int>``            sampled (or exhaustive) k-node failures
    - ``k=<int>:<samples>``  ... with a per-term sample budget
    - ``zone`` / ``rack`` / ``host``   domain outages on the standard keys
    - ``label:<key>``        domain outages on an arbitrary node-label key

    e.g. ``--faults k=1,zone`` or ``--faults k=2:500,rack``.
    """
    terms = []
    for raw in (spec or "").split(","):
        token = raw.strip()
        if not token:
            continue
        if token.startswith("k="):
            body = token[2:]
            samples = None
            if ":" in body:
                body, samples_s = body.split(":", 1)
                samples = int(samples_s)
            k = int(body)
            if k < 1:
                raise ValueError(f"fault spec term {token!r}: k must be >= 1")
            terms.append({"kind": "k", "k": k, "samples": samples})
        elif token in DOMAIN_KEYS:
            terms.append({"kind": "domain", "key": DOMAIN_KEYS[token]})
        elif token.startswith("label:"):
            terms.append({"kind": "domain", "key": token[len("label:"):]})
        else:
            raise ValueError(
                f"unrecognized fault spec term {token!r} "
                "(expected k=<int>[:<samples>], zone, rack, host, or label:<key>)"
            )
    if not terms:
        raise ValueError("empty fault spec")
    return terms


def generate_scenarios(
    nodes: List[dict],
    spec: str = "k=1",
    samples: int = 256,
    seed: int = 0,
    valid: Optional[np.ndarray] = None,
) -> ScenarioSet:
    """Scenario set for a parsed fault spec over `nodes` (see
    `parse_fault_spec`).  `samples` is the default budget for k-terms that
    carry none of their own; `valid` restricts failures to live nodes (the
    resilience planner passes each candidate's membership mask)."""
    n = len(nodes)
    sets = []
    for term in parse_fault_spec(spec):
        if term["kind"] == "k":
            if term["k"] == 1:
                # exhaustive, with real node names in the labels
                sets.append(single_node_scenarios(n, nodes=nodes, valid=valid))
            else:
                sets.append(
                    k_node_scenarios(
                        n,
                        term["k"],
                        samples=term["samples"] if term["samples"] is not None else samples,
                        seed=seed,
                        valid=valid,
                    )
                )
        else:
            sets.append(domain_scenarios(nodes, term["key"], valid=valid))
    return stack_scenarios(sets)
