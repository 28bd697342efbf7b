"""Placement report tables.

Mirrors `report()` (`pkg/apply/apply.go:306-578`): Pod Info and Node Info
tables, plus Node Local Storage / GPU tables when the matching extended
resource is enabled, the audit section `apply` prints under them, and the
survivability tables of a fault sweep (`resilience`, `apply --faults`).
Rendered with a small built-in grid writer standing in for tablewriter.
"""

from __future__ import annotations

import json
from typing import List, Sequence

from . import constants as C
from .core.objects import annotations_of, labels_of, name_of, namespace_of, pod_requests
from .core.quantity import format_quantity, parse_quantity


def render_table(header: List[str], rows: List[List[str]], merge_col0: bool = True) -> str:
    """ASCII grid with per-row separators and repeated-value merging in the
    first column (tablewriter's SetAutoMergeCellsByColumnIndex([0]))."""
    if merge_col0:
        prev = None
        merged = []
        for row in rows:
            row = list(row)
            if row and row[0] == prev:
                row[0] = ""
            else:
                prev = row[0]
            merged.append(row)
        rows = merged
    widths = [len(h) for h in header]
    for row in rows:
        for i, cell in enumerate(row):
            for line in str(cell).split("\n"):
                widths[i] = max(widths[i], len(line))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        cells = [str(c).split("\n") for c in row]
        height = max(len(c) for c in cells) if cells else 1
        lines = []
        for k in range(height):
            parts = []
            for i, c in enumerate(cells):
                text = c[k] if k < len(c) else ""
                parts.append(f" {text:<{widths[i]}} ")
            lines.append("|" + "|".join(parts) + "|")
        return "\n".join(lines)

    out = [sep, fmt(header).upper(), sep]
    for row in rows:
        out.append(fmt(row))
        out.append(sep)
    return "\n".join(out)


def _pct(num: float, den: float) -> int:
    return int(num / den * 100) if den else 0


def resilience_report(sweep, top: int = 10) -> str:
    """Survivability tables for one fault sweep (`faults.sweep.SweepResult`):
    the per-kind scenario tally, the worst scenarios, and the single-node
    criticality ranking — the section `simtpu resilience` (and
    `simtpu apply --faults`) prints under the placement report."""
    out = ["Resilience"]
    by_kind: dict = {}
    for s in range(len(sweep.scenarios)):
        kind = sweep.scenarios.labels[s].split(":", 1)[0]
        rec = by_kind.setdefault(kind, [0, 0, 0])
        rec[0] += 1
        rec[1] += int(sweep.unplaced[s] == 0)
        rec[2] = max(rec[2], int(sweep.unplaced[s]))
    rows = [
        [kind, str(total), str(ok), f"{_pct(ok, total)}%", str(worst)]
        for kind, (total, ok, worst) in sorted(by_kind.items())
    ]
    out.append(
        render_table(
            ["Failure Kind", "Scenarios", "Survived", "Survival", "Max Unplaced"],
            rows,
            merge_col0=False,
        )
    )
    worst = sweep.worst(top)
    if worst:
        out.append("\nWorst Scenarios")
        out.append(
            render_table(
                ["Scenario", "Unplaced Pods"],
                [[lbl, str(n)] for lbl, n in worst],
                merge_col0=False,
            )
        )
    crit = sweep.critical_nodes(top)
    if crit:
        out.append("\nMost Critical Nodes")
        out.append(
            render_table(
                ["Node", "Pods Stranded By Its Loss"],
                [[node, str(n)] for node, n in crit],
                merge_col0=False,
            )
        )
    return "\n".join(out)


def audit_report(doc: dict) -> str:
    """Render one audit record (`audit/checker.py AuditReport.counters()` /
    a planner's `PlanResult.audit` doc) as the section the CLI prints
    under the placement report.

    Clean audits render one line; a dirty audit renders the per-violation
    witness table (pod, node, constraint class, witness values) and —
    when the divergence-safe fallback ran — the divergence diagnostic
    (first divergent pod, differing state planes) and the fallback's own
    verdict."""
    if not doc:
        return "Audit: not run (--no-audit)"
    out: List[str] = []
    if doc.get("fallback"):
        fb = doc.get("fallback_audit") or {}
        verdict = "certified" if fb.get("ok") else "NOT certified"
        out.append(
            f"Audit: PRIMARY ENGINE DIVERGED — {doc.get('violations', 0)} "
            f"violation(s) over {doc.get('checked', 0)} placements; "
            f"serial-exact fallback {verdict}"
        )
    elif doc.get("ok", False):
        return (
            f"Audit: clean ({doc.get('checked', 0)} placements certified, "
            f"{doc.get('wall_s', 0.0):.3f}s, {doc.get('mode', '?')} mode)"
        )
    else:
        out.append(
            f"Audit: FAILED — {doc.get('violations', 0)} violation(s) "
            f"over {doc.get('checked', 0)} placements"
        )
    detail = doc.get("detail") or []
    if detail:
        rows = [
            [
                v.get("class", ""),
                v.get("pod", ""),
                v.get("node", ""),
                ", ".join(f"{k}={w}" for k, w in (v.get("witness") or {}).items()),
            ]
            for v in detail
        ]
        out.append(
            render_table(
                ["Constraint Class", "Pod", "Node", "Witness"],
                rows,
                merge_col0=False,
            )
        )
    div = doc.get("divergence") or {}
    if div:
        lines = ["Divergence diagnostic:"]
        for key in (
            "divergent_pods",
            "first_divergent_row",
            "first_divergent_pod",
            "audited_node",
            "serial_node",
            "nodes_changed",
            "first_changed_node",
        ):
            if key in div and div[key] not in ("", None):
                lines.append(f"  {key}: {div[key]}")
        planes = div.get("state_planes") or []
        if planes:
            lines.append("  differing state planes: " + "; ".join(planes))
        out.append("\n".join(lines))
    return "\n".join(out)


def solve_report(doc: dict) -> str:
    """Render one global-solver consult record (`PlanResult.solve` /
    `ResiliencePlan.solve`) as a one-to-two line section under the
    placement report: accepted answers name the certified count,
    everything else names why the exact search took over (and what warm
    start, if any, it inherited)."""
    if not doc or not doc.get("enabled"):
        return "Solver: not consulted (--no-solver)"
    status = doc.get("status", "?")
    wall = doc.get("wall_s", 0.0)
    if status == "accepted":
        return (f"Solver: accepted — {doc.get('k', '?')} node(s), minimality certified at k-1, "
                f"residual {doc.get('residual', 0.0):.2e}, {wall:.3f}s")
    if status == "accepted_fallback":
        return (f"Solver: audit rejected the rounded placement — serial exact engine re-placed at "
                f"the certified count {doc.get('k', '?')} ({wall:.3f}s)")
    if status == "certified":  # lower-bound-only mode (resilience)
        return (f"Solver: certified lower bound {doc.get('lower_bound', 0)} "
                f"(warm-started the survivability search, {wall:.3f}s)")
    out = [f"Solver: {status} — exact search answered ({doc.get('reason', 'no reason recorded')}, {wall:.3f}s)"]
    if doc.get("certified_lb") and doc.get("lower_bound"):
        out.append(f"  certified lower bound {doc['lower_bound']} warm-started the exact search")
    return "\n".join(out)


def contain_local_storage(extended: Sequence[str]) -> bool:
    return "open-local" in extended


def contain_gpu(extended: Sequence[str]) -> bool:
    return "gpu" in extended


def report(node_statuses, extended_resources: Sequence[str] = ()) -> str:
    """Build the full report text (`pkg/apply/apply.go:306-578`)."""
    out = []
    with_storage = contain_local_storage(extended_resources)
    with_gpu = contain_gpu(extended_resources)

    # ---- Pod Info -------------------------------------------------------
    header = ["Node", "Pod", "CPU Requests", "Memory Requests"]
    if with_storage:
        header.append("Volume Request")
    if with_gpu:
        header.append("GPU Mem Requests")
    header.append("APP Name")
    rows = []
    for status in node_statuses:
        node = status.node
        alloc = ((node.get("status") or {}).get("allocatable")) or {}
        cpu_alloc = parse_quantity(alloc.get("cpu"))
        mem_alloc = parse_quantity(alloc.get("memory"))
        gpu_alloc = parse_quantity(alloc.get(C.RES_GPU_MEM))
        for pod in status.pods:
            req = pod_requests(pod)
            cpu = req.get("cpu", 0.0)
            mem = req.get("memory", 0.0)
            row = [
                name_of(node),
                f"{namespace_of(pod)}/{name_of(pod)}",
                f"{format_quantity(cpu, 'cpu')}({_pct(cpu, cpu_alloc)}%)",
                f"{format_quantity(mem, 'mem')}({_pct(mem, mem_alloc)}%)",
            ]
            if with_storage:
                vol_lines = []
                raw = annotations_of(pod).get(C.ANNO_POD_LOCAL_STORAGE)
                if raw:
                    vols = (json.loads(raw) or {}).get("volumes") or []
                    for i, vol in enumerate(vols):
                        size = parse_quantity(vol.get("size"))
                        vol_lines.append(f"<{i}> {vol.get('kind')}: {format_quantity(size, 'mem')}")
                row.append("\n".join(vol_lines))
            if with_gpu:
                annos = annotations_of(pod)
                gpu_mem = parse_quantity(annos.get(C.ANNO_POD_GPU_MEM, 0))
                gpu_cnt = parse_quantity(annos.get(C.ANNO_POD_GPU_COUNT, 0))
                total = gpu_mem * gpu_cnt
                row.append(f"{format_quantity(total, 'mem')}({_pct(total, gpu_alloc)}%)")
            row.append(labels_of(pod).get(C.LABEL_APP_NAME, ""))
            rows.append(row)
    out.append("Pod Info")
    out.append(render_table(header, rows))
    out.append("")

    # ---- Node Info ------------------------------------------------------
    header = ["Node", "CPU Allocatable", "CPU Requests", "Memory Allocatable", "Memory Requests"]
    if with_gpu:
        header += ["GPU Mem Allocatable", "GPU Mem Requests"]
    header += ["Pod Count", "New Node"]
    rows = []
    for status in node_statuses:
        node = status.node
        alloc = ((node.get("status") or {}).get("allocatable")) or {}
        cpu_alloc = parse_quantity(alloc.get("cpu"))
        mem_alloc = parse_quantity(alloc.get("memory"))
        cpu_req = mem_req = gpu_req = 0.0
        for pod in status.pods:
            req = pod_requests(pod)
            cpu_req += req.get("cpu", 0.0)
            mem_req += req.get("memory", 0.0)
            annos = annotations_of(pod)
            gpu_req += parse_quantity(annos.get(C.ANNO_POD_GPU_MEM, 0)) * parse_quantity(
                annos.get(C.ANNO_POD_GPU_COUNT, 0)
            )
        row = [
            name_of(node),
            format_quantity(cpu_alloc, "cpu"),
            f"{format_quantity(cpu_req, 'cpu')}({_pct(cpu_req, cpu_alloc)}%)",
            format_quantity(mem_alloc, "mem"),
            f"{format_quantity(mem_req, 'mem')}({_pct(mem_req, mem_alloc)}%)",
        ]
        if with_gpu:
            gpu_alloc = parse_quantity(alloc.get(C.RES_GPU_MEM))
            row += [
                format_quantity(gpu_alloc, "mem"),
                f"{format_quantity(gpu_req, 'mem')}({_pct(gpu_req, gpu_alloc)}%)",
            ]
        row += [
            str(len(status.pods)),
            "√" if C.LABEL_NEW_NODE in labels_of(node) else "",
        ]
        rows.append(row)
    out.append("Node Info")
    out.append(render_table(header, rows, merge_col0=False))
    out.append("")

    # ---- Extended Resource Info ----------------------------------------
    if with_storage or with_gpu:
        out.append("Extended Resource Info")
    if with_storage:
        out.append("Node Local Storage")
        rows = []
        for status in node_statuses:
            node = status.node
            raw = annotations_of(node).get(C.ANNO_NODE_LOCAL_STORAGE)
            if not raw:
                continue
            storage = json.loads(raw)
            for vg in storage.get("vgs") or []:
                cap = parse_quantity(vg.get("capacity"))
                req = parse_quantity(vg.get("requested"))
                rows.append(
                    [
                        name_of(node),
                        "VG",
                        vg.get("name", ""),
                        format_quantity(cap, "mem"),
                        f"{format_quantity(req, 'mem')}({_pct(req, cap)}%)",
                    ]
                )
            for dev in storage.get("devices") or []:
                cap = parse_quantity(dev.get("capacity"))
                used = "used" if str(dev.get("isAllocated")).lower() == "true" else "unused"
                rows.append(
                    [
                        name_of(node),
                        f"Device({dev.get('mediaType')})",
                        dev.get("device", ""),
                        format_quantity(cap, "mem"),
                        used,
                    ]
                )
        out.append(
            render_table(
                ["Node", "Storage Kind", "Storage Name", "Storage Allocatable", "Storage Requests"],
                rows,
            )
        )
    if with_gpu:
        out.append("GPU Node Resource")
        rows = []
        pod_rows = []
        for status in node_statuses:
            node = status.node
            raw = annotations_of(node).get(C.ANNO_NODE_GPU_SHARE)
            if raw:
                info = json.loads(raw)
                model = labels_of(node).get(C.LABEL_GPU_CARD_MODEL, "N/A")
                total = info.get("gpuTotalMemory", 0)
                used = info.get("gpuUsedMemory", 0)
                rows.append(
                    [
                        f"{name_of(node)} ({model})",
                        f"{info.get('gpuCount', 0)} GPUs",
                        f"{format_quantity(used, 'mem')}/{format_quantity(total, 'mem')}"
                        f"({_pct(used, total)}%)",
                        f"{info.get('numPods', 0)} Pods",
                    ]
                )
                for idx, dev in sorted((info.get("devs") or {}).items(), key=lambda kv: int(kv[0])):
                    dtotal, dused = dev.get("gpuTotalMemory", 0), dev.get("gpuUsedMemory", 0)
                    rows.append(
                        [
                            f"{name_of(node)} ({model})",
                            str(idx),
                            f"{format_quantity(dused, 'mem')}/{format_quantity(dtotal, 'mem')}"
                            f"({_pct(dused, dtotal)}%)",
                            "",
                        ]
                    )
            for pod in status.pods:
                annos = annotations_of(pod)
                req = pod_requests(pod)
                gpu_mem = parse_quantity(annos.get(C.ANNO_POD_GPU_MEM, 0))
                gpu_cnt = parse_quantity(annos.get(C.ANNO_POD_GPU_COUNT, 0))
                pod_rows.append(
                    [
                        name_of(pod),
                        format_quantity(req.get("cpu", 0.0), "cpu"),
                        format_quantity(req.get("memory", 0.0), "mem"),
                        format_quantity(gpu_mem * gpu_cnt, "mem"),
                        (pod.get("spec") or {}).get("nodeName", ""),
                        annos.get(C.ANNO_POD_GPU_INDEX, ""),
                    ]
                )
        out.append(render_table(["Node", "GPU ID", "GPU Request/Capacity", "Pod List"], rows))
        out.append("\nPod -> Node Map")
        pod_rows.sort(key=lambda r: r[0])
        out.append(
            render_table(
                ["Pod", "CPU Req", "Mem Req", "GPU Req", "Host Node", "GPU IDX"],
                pod_rows,
                merge_col0=False,
            )
        )
    return "\n".join(out)


def _fmt_res(name: str, val: float) -> str:
    if name == "cpu":
        return format_quantity(val, "cpu")
    if name in ("memory", "ephemeral-storage"):
        return format_quantity(val, "mem")
    return f"{val:g}"


def explain_report(doc: dict) -> str:
    """Render one decision-observability record (explain/ — the versioned
    `explain` block of `--json`) as the section the `explain` subcommand
    and `--explain` print under the placement report.

    Three sub-sections, each present only when its data is: the per-pod
    failure breakdown (kube-scheduler-style status strings, grouped by
    identical failure shape), the binding-constraint bottleneck table,
    and the per-plugin score attribution rows."""
    if not doc:
        return "Explain: nothing to explain (no unplaced pods selected)"
    out: List[str] = []
    failures = doc.get("failures") or {}
    groups = failures.get("groups") or []
    if groups:
        out.append(
            f"Why Unschedulable ({failures.get('unplaced', 0)} pod(s), "
            f"{failures.get('n_nodes', 0)} node(s), "
            f"{failures.get('mode', '?')} pass)"
        )
        rows = []
        for g in groups:
            lines = [
                f"{cnt} {stage}"
                for stage, cnt in (g.get("stages") or {}).items()
            ]
            wit = g.get("witnesses") or {}
            wit_lines = [
                f"{stage}: {', '.join(names)}"
                for stage, names in wit.items()
                if names
            ]
            rows.append(
                [
                    str(g.get("pods", 0)),
                    g.get("example", ""),
                    g.get("status", ""),
                    "\n".join(lines),
                    "\n".join(wit_lines),
                ]
            )
        out.append(
            render_table(
                ["Pods", "Example", "Status", "Stage Counts", "Witness Nodes"],
                rows,
                merge_col0=False,
            )
        )
        if failures.get("truncated_groups"):
            out.append(
                f"... {failures['truncated_groups']} more failure shape(s) "
                "truncated (raise --top to see them)"
            )
    bottleneck = doc.get("bottleneck") or {}
    if bottleneck:
        scope = (
            f" — worst scenario {doc['worst_scenario']!r}"
            if doc.get("worst_scenario")
            else ""
        )
        out.append(
            "\nBottleneck (binding constraints over the unplaced set"
            f"{scope})"
        )
        by_reason = bottleneck.get("by_reason") or {}
        if by_reason:
            out.append(
                render_table(
                    ["Failure Reason", "Pods"],
                    [[r, str(n)] for r, n in by_reason.items()],
                    merge_col0=False,
                )
            )
        rows = [
            [
                r.get("resource", ""),
                _fmt_res(r.get("resource", ""), r.get("requested", 0.0)),
                _fmt_res(r.get("resource", ""), r.get("free", 0.0)),
                f"{r.get('share', 0.0):g}",
                "√" if r.get("fragmented") else "",
            ]
            for r in bottleneck.get("resources") or []
        ]
        if rows:
            out.append(
                render_table(
                    ["Resource", "Requested (unplaced)", "Free", "Share", "Fragmented"],
                    rows,
                    merge_col0=False,
                )
            )
        binding = bottleneck.get("binding")
        if binding:
            out.append(
                f"binding constraint: {binding.get('resource')} — unplaced "
                f"pods request "
                f"{_fmt_res(binding.get('resource', ''), binding.get('requested', 0.0))} "
                f"against "
                f"{_fmt_res(binding.get('resource', ''), binding.get('free', 0.0))} free"
            )
        out.append(
            f"failure shapes: {bottleneck.get('capacity_shaped', 0)} "
            "capacity-shaped (more/larger nodes can help), "
            f"{bottleneck.get('constraint_shaped', 0)} constraint-shaped "
            "(capacity alone cannot)"
        )
        template = bottleneck.get("template") or {}
        if template:
            line = (
                f"template verdict: {template.get('helpable', 0)} of "
                f"{template.get('probed', 0)} probed pod(s) could land on "
                "another template node"
            )
            if template.get("never_helpable"):
                line += (
                    f"; {template['never_helpable']} never can "
                    f"({template.get('never_reason', '')})"
                )
            if template.get("template_nodes_hint"):
                line += (
                    f"; resource deficit ≈ "
                    f"{template['template_nodes_hint']} template node(s)"
                )
            out.append(line)
    scores = doc.get("scores") or []
    if scores:
        out.append("\nScore Attribution (per-plugin decomposition)")
        rows = []
        for s in scores:
            top_terms = sorted(
                (t for t in s.get("terms") or [] if t.get("delta")),
                key=lambda t: -abs(t.get("delta") or 0.0),
            )[:3]
            rows.append(
                [
                    s.get("pod", ""),
                    s.get("node", ""),
                    s.get("runner_up", ""),
                    "" if s.get("margin") is None else f"{s['margin']:g}",
                    "\n".join(
                        f"{t['plugin']}: {t['delta']:+g} (w={t['weight']:g})"
                        for t in top_terms
                    ),
                    "" if s.get("consistent", True) else "recompute diverged",
                ]
            )
        out.append(
            render_table(
                ["Pod", "Node", "Runner-Up", "Margin", "Deciding Terms", "Note"],
                rows,
                merge_col0=False,
            )
        )
    if not out:
        return "Explain: nothing to explain (no unplaced pods selected)"
    return "\n".join(out)
