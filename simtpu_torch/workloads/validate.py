"""Object validation.

The reference runs the full upstream API validation on every generated pod
and node (`pkg/utils/utils.go:516-529,654-668` →
k8s.io/kubernetes/pkg/apis/core/validation).  We enforce the slice of those
rules whose violation would otherwise change SCHEDULING semantics silently
— malformed labels/selectors (match nothing they should), bad affinity
operators (tensorize would treat them as no-match), out-of-range host
ports, invalid spread constraints, unparseable or negative quantities —
plus the basic object-identity rules.  Anything violating them raises
ValidationError before tensorization, so the engine never sees malformed
inputs; everything upstream validates beyond scheduling relevance
(security contexts, probes, env, image syntax, ...) is deliberately out of
scope and documented so.
"""

from __future__ import annotations

import re

from ..core.objects import (
    meta,
    name_of,
    namespace_of,
    pod_containers,
    pod_requests,
    pod_spec,
)

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$")
# label VALUE / qualified-name NAME part: alphanumeric ends, [-_.] inside
_LABEL_PART = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")

_SELECTOR_OPS = {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
_TOLERATION_OPS = {"", "Equal", "Exists"}
_TAINT_EFFECTS = {"", "NoSchedule", "PreferNoSchedule", "NoExecute"}
_UNSATISFIABLE = {"DoNotSchedule", "ScheduleAnyway"}
_PROTOCOLS = {"TCP", "UDP", "SCTP"}


class ValidationError(ValueError):
    pass


class SpecError(ValidationError):
    """A malformed workload spec, carrying enough context to fix it.

    Before this class, a bad resource quantity or malformed field
    surfaced as a raw `ValueError` traceback mid-tensorize with no hint
    of WHICH manifest was broken.  A SpecError renders as one actionable
    line — `<file>: <Kind> <ns>/<name>: <field.path>: <reason>` — and
    `simtpu apply` prints exactly that (plus the same line under --json's
    "message") instead of a stack.

    The reason is raised where the malformed value is seen (with the
    field path when known); the expansion boundary
    (`expand.spec_context`) attaches the workload kind/name and source
    file, which only the ingest layer knows."""

    def __init__(
        self,
        reason: str,
        source: str = None,
        kind: str = None,
        name: str = None,
        field: str = None,
    ):
        self.reason = reason
        self.source = source
        self.kind = kind
        self.name = name
        self.field = field
        super().__init__(reason)

    def attach(
        self, source: str = None, kind: str = None, name: str = None
    ) -> "SpecError":
        """Fill ingest context the raise site didn't know (missing attrs
        only — the innermost context wins)."""
        self.source = self.source or source
        self.kind = self.kind or kind
        self.name = self.name or name
        return self

    def __str__(self) -> str:
        parts = []
        if self.source:
            parts.append(str(self.source))
        if self.kind or self.name:
            parts.append(f"{self.kind or 'object'} {self.name or '?'}")
        if self.field:
            parts.append(self.field)
        parts.append(self.reason)
        return ": ".join(parts)


def _validate_name(name: str, what: str) -> None:
    if not name or len(name) > 253 or not _DNS1123.match(name):
        raise ValidationError(f"invalid {what} name: {name!r}")


def _validate_label_key(key, where: str) -> None:
    """Qualified-name rule (`apimachinery validation.IsQualifiedName`):
    optional DNS-subdomain prefix + '/', name part <= 63 chars."""
    if not isinstance(key, str) or not key:
        raise ValidationError(f"{where}: empty or non-string label key")
    prefix, sep, name = key.rpartition("/")
    if sep and (not prefix or len(prefix) > 253 or not _DNS1123.match(prefix)):
        # upstream rejects "/name" outright: a present slash demands a
        # non-empty valid DNS-subdomain prefix (IsQualifiedName)
        raise ValidationError(f"{where}: invalid label key prefix {prefix!r}")
    if not name or len(name) > 63 or not _LABEL_PART.match(name):
        raise ValidationError(f"{where}: invalid label key {key!r}")


def _validate_label_value(value, key, where: str) -> None:
    """`validation.IsValidLabelValue`: empty, or <= 63 chars of the label
    charset — scheduling matches string-compare these, so a malformed value
    would silently never match a well-formed selector."""
    if not isinstance(value, str):
        raise ValidationError(f"{where}: non-string label value for {key!r}")
    if value and (len(value) > 63 or not _LABEL_PART.match(value)):
        raise ValidationError(f"{where}: invalid label value {value!r} for {key!r}")


def _validate_labels(labels: dict, where: str) -> None:
    for k, v in (labels or {}).items():
        _validate_label_key(k, where)
        _validate_label_value(v, k, where)


_LABEL_SELECTOR_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist"})


def _validate_match_expressions(
    exprs, where: str, allowed_ops: frozenset = frozenset(_SELECTOR_OPS)
) -> None:
    """NodeSelectorRequirement / LabelSelectorRequirement rules
    (`apivalidation ValidateNodeSelectorRequirement`,
    `metav1validation.ValidateLabelSelector`): the KEY is a qualified name,
    operator in `allowed_ops`; Exists/DoesNotExist take no values; In/NotIn
    need label-valid values; Gt/Lt take exactly one integer."""
    for req in exprs or []:
        _validate_label_key(req.get("key"), where)
        op = req.get("operator")
        if op not in allowed_ops:
            raise ValidationError(f"{where}: invalid selector operator {op!r}")
        values = req.get("values") or []
        if op in ("Exists", "DoesNotExist") and values:
            raise ValidationError(f"{where}: operator {op} must not carry values")
        if op in ("In", "NotIn"):
            if not values:
                raise ValidationError(f"{where}: operator {op} requires values")
            for v in values:
                _validate_label_value(v, req.get("key"), where)
        if op in ("Gt", "Lt"):
            if len(values) != 1:
                raise ValidationError(f"{where}: operator {op} takes exactly one value")
            try:
                int(values[0])
            except (TypeError, ValueError):
                raise ValidationError(
                    f"{where}: operator {op} value {values[0]!r} is not an integer"
                )


def _validate_match_fields(fields, where: str) -> None:
    """NodeSelectorTerm.matchFields (`apivalidation
    ValidateNodeFieldSelectorRequirement`): only metadata.name, operator
    In, exactly one value — tensorize evaluates these (DaemonSet pinning),
    so a malformed term would silently match nothing."""
    for req in fields or []:
        if req.get("key") != "metadata.name":
            raise ValidationError(
                f"{where}: matchFields key must be metadata.name, got {req.get('key')!r}"
            )
        if req.get("operator") != "In":
            raise ValidationError(
                f"{where}: matchFields operator must be In, got {req.get('operator')!r}"
            )
        if len(req.get("values") or []) != 1:
            raise ValidationError(f"{where}: matchFields takes exactly one value")


def _validate_label_selector(sel: dict, where: str) -> None:
    """LabelSelector rules (`metav1validation.ValidateLabelSelector`)."""
    for k, v in ((sel or {}).get("matchLabels") or {}).items():
        _validate_label_key(k, where)
        _validate_label_value(v, k, where)
    _validate_match_expressions(
        (sel or {}).get("matchExpressions"), where, _LABEL_SELECTOR_OPS
    )


def _validate_affinity(pod: dict) -> None:
    who = f"pod {name_of(pod)}"
    aff = pod_spec(pod).get("affinity") or {}
    node_aff = aff.get("nodeAffinity") or {}
    required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in required.get("nodeSelectorTerms") or []:
        _validate_match_expressions(
            term.get("matchExpressions"), f"{who} nodeAffinity"
        )
        _validate_match_fields(term.get("matchFields"), f"{who} nodeAffinity")
    for pref in node_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        _validate_match_expressions(
            (pref.get("preference") or {}).get("matchExpressions"),
            f"{who} nodeAffinity preference",
        )
    for kind in ("podAffinity", "podAntiAffinity"):
        block = aff.get(kind) or {}
        for term in block.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
            if not term.get("topologyKey"):
                raise ValidationError(f"{who} {kind}: required term without topologyKey")
            _validate_label_selector(term.get("labelSelector"), f"{who} {kind}")
        for w in block.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            term = w.get("podAffinityTerm") or {}
            if not term.get("topologyKey"):
                raise ValidationError(f"{who} {kind}: preferred term without topologyKey")
            _validate_label_selector(term.get("labelSelector"), f"{who} {kind}")


def _validate_spread(pod: dict) -> None:
    who = f"pod {name_of(pod)}"
    for c in pod_spec(pod).get("topologySpreadConstraints") or []:
        try:
            skew = int(c.get("maxSkew"))
        except (TypeError, ValueError):
            skew = 0
        if skew < 1:
            raise ValidationError(f"{who}: topologySpreadConstraint maxSkew must be >= 1")
        if not c.get("topologyKey"):
            raise ValidationError(f"{who}: topologySpreadConstraint without topologyKey")
        if c.get("whenUnsatisfiable") not in _UNSATISFIABLE:
            raise ValidationError(
                f"{who}: invalid whenUnsatisfiable {c.get('whenUnsatisfiable')!r}"
            )
        _validate_label_selector(c.get("labelSelector"), f"{who} spread")


def _validate_tolerations(pod: dict) -> None:
    who = f"pod {name_of(pod)}"
    for t in pod_spec(pod).get("tolerations") or []:
        if t.get("operator", "") not in _TOLERATION_OPS:
            raise ValidationError(
                f"{who}: invalid toleration operator {t.get('operator')!r}"
            )
        if t.get("operator") == "Exists" and t.get("value"):
            raise ValidationError(f"{who}: Exists toleration must not carry a value")
        if t.get("effect", "") not in _TAINT_EFFECTS:
            raise ValidationError(f"{who}: invalid toleration effect {t.get('effect')!r}")


def _validate_ports(pod: dict) -> None:
    who = f"pod {name_of(pod)}"
    for c in pod_containers(pod):
        for p in c.get("ports") or []:
            host = p.get("hostPort")
            if host is not None:
                try:
                    ok = 0 < int(host) <= 65535
                except (TypeError, ValueError):
                    ok = False
                if not ok:
                    raise ValidationError(f"{who}: invalid hostPort {host!r}")
            proto = p.get("protocol", "TCP")
            if proto not in _PROTOCOLS:
                raise ValidationError(f"{who}: invalid port protocol {proto!r}")


def _validate_quantities(pod: dict) -> None:
    """Resource quantities, walked per container so a bad value reports
    its exact FIELD PATH (`spec.containers[1].resources.requests.cpu`)
    instead of the raw `unparseable quantity` ValueError the aggregated
    `pod_requests` sum would throw mid-tensorize."""
    from ..core.quantity import parse_quantity

    spec = pod_spec(pod)
    walks = [
        (f"spec.containers[{i}]", c)
        for i, c in enumerate(spec.get("containers") or [])
    ] + [
        (f"spec.initContainers[{i}]", c)
        for i, c in enumerate(spec.get("initContainers") or [])
    ]
    entries = [
        (f"{where}.resources.{section}.{k}", v)
        for where, c in walks
        for section in ("requests", "limits")
        for k, v in ((c.get("resources") or {}).get(section) or {}).items()
    ] + [
        (f"spec.overhead.{k}", v)
        for k, v in (spec.get("overhead") or {}).items()
    ]
    for field, v in entries:
        try:
            q = parse_quantity(v)
        except Exception:
            raise SpecError(
                f"unparseable resource quantity {v!r}", field=field
            ) from None
        if q < 0:
            raise SpecError(f"negative resource quantity {v!r}", field=field)


def validate_pod(pod: dict) -> None:
    _validate_name(name_of(pod), "pod")
    _validate_name(namespace_of(pod), "namespace")
    _validate_labels(meta(pod).get("labels"), f"pod {name_of(pod)}")
    containers = pod_containers(pod)
    if not containers:
        raise ValidationError(f"pod {name_of(pod)} has no containers")
    seen = set()
    for c in containers:
        cname = c.get("name")
        if not cname:
            raise ValidationError(f"pod {name_of(pod)} has a container without a name")
        if cname in seen:
            raise ValidationError(f"pod {name_of(pod)} has duplicate container name {cname}")
        seen.add(cname)
    _validate_quantities(pod)
    restart = (pod.get("spec") or {}).get("restartPolicy", "Always")
    if restart not in ("Always", "OnFailure", "Never"):
        raise ValidationError(f"pod {name_of(pod)} has invalid restartPolicy {restart!r}")
    for k, v in (pod_spec(pod).get("nodeSelector") or {}).items():
        _validate_label_key(k, f"pod {name_of(pod)} nodeSelector")
        _validate_label_value(v, k, f"pod {name_of(pod)} nodeSelector")
    _validate_affinity(pod)
    _validate_spread(pod)
    _validate_tolerations(pod)
    _validate_ports(pod)


def validate_node(node: dict) -> None:
    _validate_name(name_of(node), "node")
    _validate_labels(meta(node).get("labels"), f"node {name_of(node)}")
    from ..constants import LABEL_HOSTNAME
    from ..core.quantity import parse_quantity

    labels = meta(node).get("labels") or {}
    if LABEL_HOSTNAME in labels and labels[LABEL_HOSTNAME] != name_of(node):
        # mirror of upstream rule: hostname label, when present, must equal name
        # (the reference sets it explicitly in MakeValidNodeByNode, utils.go:505)
        raise ValidationError(
            f"node {name_of(node)}: hostname label {labels[LABEL_HOSTNAME]!r} != name"
        )
    for section in ("allocatable", "capacity"):
        for k, v in ((node.get("status") or {}).get(section) or {}).items():
            try:
                q = parse_quantity(v)
            except Exception:
                raise ValidationError(
                    f"node {name_of(node)}: unparseable {section} quantity {k}={v!r}"
                )
            if q < 0:
                raise ValidationError(
                    f"node {name_of(node)}: negative {section} quantity {k}={v!r}"
                )
