"""Host-side label/selector/taint predicate evaluation.

These are the scalar (one pod × one node) forms of the scheduling predicates,
used where the reference also runs them host-side: DaemonSet expansion
(`pkg/utils/utils.go:388-395` via vendored `daemon.Predicates`,
`daemon_controller.go:1251-1257`) and planner diagnostics
(`pkg/apply/apply.go:215-231`). The batched forms over all nodes live in
kernels/ and are built from the same semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .objects import (
    labels_of,
    name_of,
    node_taints,
    pod_affinity,
    pod_node_selector,
    pod_tolerations,
)

# NodeSelectorRequirement operators (k8s core/v1 types)
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


def match_requirement(values: Dict[str, str], req: dict) -> bool:
    """Evaluate one NodeSelectorRequirement against a key→value map.

    Semantics follow apimachinery labels.Requirement.Matches
    (`vendor/k8s.io/apimachinery/pkg/labels/selector.go:203-238`): NotIn
    matches when the key is absent; Gt/Lt require the key present.
    """
    key = req.get("key", "")
    op = req.get("operator", "")
    vals = req.get("values") or []
    present = key in values
    if op == OP_IN:
        return present and values[key] in vals
    if op == OP_NOT_IN:
        return not present or values[key] not in vals
    if op == OP_EXISTS:
        return present
    if op == OP_DOES_NOT_EXIST:
        return not present
    if op == OP_GT or op == OP_LT:
        if not present or not vals:
            return False
        try:
            lhs = int(values[key])
            rhs = int(vals[0])
        except ValueError:
            return False
        return lhs > rhs if op == OP_GT else lhs < rhs
    return False


def match_node_selector_term(term: dict, node: dict) -> bool:
    """One NodeSelectorTerm: AND of matchExpressions (over labels) and
    matchFields (over metadata.name)."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False  # empty term matches nothing (k8s semantics)
    node_labels = labels_of(node)
    for req in exprs:
        if not match_requirement(node_labels, req):
            return False
    field_map = {"metadata.name": name_of(node)}
    for req in fields:
        if not match_requirement(field_map, req):
            return False
    return True


def pod_matches_node_selector_and_affinity(pod: dict, node: dict) -> bool:
    """NodeSelector AND required node-affinity terms (OR across terms).

    Mirrors `pluginhelper.PodMatchesNodeSelectorAndAffinityTerms` used by both
    the NodeAffinity filter plugin and daemon.Predicates.
    """
    selector = pod_node_selector(pod)
    if selector:
        node_labels = labels_of(node)
        for k, v in selector.items():
            if node_labels.get(k) != v:
                return False
    node_affinity = (pod_affinity(pod)).get("nodeAffinity") or {}
    required = node_affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required is not None:
        terms = required.get("nodeSelectorTerms") or []
        if not any(match_node_selector_term(t, node) for t in terms):
            return False
    return True


def toleration_tolerates_taint(toleration: dict, taint: dict) -> bool:
    """Mirror of v1helper.TolerationsTolerateTaint single-pair check."""
    t_effect = toleration.get("effect", "")
    if t_effect and t_effect != taint.get("effect", ""):
        return False
    t_key = toleration.get("key", "")
    if t_key and t_key != taint.get("key", ""):
        return False
    op = toleration.get("operator") or "Equal"
    if op == "Exists":
        return True
    if op == "Equal":
        return toleration.get("value", "") == taint.get("value", "")
    return False


def tolerations_tolerate_taints(
    tolerations: List[dict], taints: List[dict], effects: Optional[List[str]] = None
) -> bool:
    """All taints (optionally restricted to given effects) must be tolerated."""
    for taint in taints:
        if effects is not None and taint.get("effect") not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
            return False
    return True


def pod_tolerates_node_taints(pod: dict, node: dict, include_prefer: bool = False) -> bool:
    """TaintToleration filter: NoSchedule (+NoExecute) taints must be tolerated.

    The scheduler's filter ignores PreferNoSchedule (`tainttoleration` plugin);
    daemon.Predicates filters on NoSchedule+NoExecute the same way.
    """
    effects = ["NoSchedule", "NoExecute"]
    if include_prefer:
        effects.append("PreferNoSchedule")
    return tolerations_tolerate_taints(pod_tolerations(pod), node_taints(node), effects)


def node_should_run_pod(node: dict, pod: dict) -> bool:
    """Would a DaemonSet pod pinned to this node ever run here?

    Mirrors `utils.NodeShouldRunPod` (`pkg/utils/utils.go:388-395`) →
    daemon.Predicates (`daemon_controller.go:1251-1257`): node-name match,
    selector+affinity match, and NoSchedule/NoExecute taints tolerated.
    """
    from .objects import pod_node_name

    fits_node_name = not pod_node_name(pod) or pod_node_name(pod) == name_of(node)
    fits_affinity = pod_matches_node_selector_and_affinity(pod, node)
    fits_taints = pod_tolerates_node_taints(pod, node)
    return fits_node_name and fits_affinity and fits_taints


def match_label_selector(selector: dict, target_labels: Dict[str, str]) -> bool:
    """metav1.LabelSelector: matchLabels AND matchExpressions.

    A nil selector matches nothing; an empty selector matches everything
    (apimachinery LabelSelectorAsSelector semantics).
    """
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if target_labels.get(k) != v:
            return False
    for req in selector.get("matchExpressions") or []:
        if req.get("operator") not in (OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST):
            return False
        if not match_requirement(target_labels, req):
            return False
    return True
