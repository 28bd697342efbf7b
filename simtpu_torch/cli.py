"""The port's command line: `python -m simtpu_torch.cli apply | resilience |
explain | fuzz`.

The `apply`, `resilience`, `explain` and `fuzz` commands of the JAX
package's `simtpu` CLI.
`apply` (the reference's `simon apply`, `cmd/apply/apply.go:26-37`) plans
the minimum number of template nodes that deploys the app list, prints the
report tables (or, with `--json`, the machine-readable plan) and, with
`--faults`, sweeps failure scenarios over the winning cluster.
`resilience` drains and requeues every generated failure scenario against
the configured cluster, or with `--plan` searches the minimum clone count
whose cluster survives them. `--explain` on both attaches the
decision-observability block (failure breakdowns, bottleneck analysis) to
a failing plan. `explain` places the configured problem through one engine
and explains the outcome (`--scores N` decomposes placed pods' scores);
`fuzz` replays seeded gnarly cases across the engine-config matrix
(`--mutation-kill`: corrupts accepted placements and counts the auditor's
detections). Exit 0 on a plan (a surviving cluster, a clean fuzz), 1 on
failure, 4 when the auditor caught a divergence (or a fuzz finding). Every
simulation runs on `--device` (default `cuda`; `cpu` runs the plain
PyTorch path). The JAX CLI's other commands and flags are not ported yet
(ROADMAP queue 1: `--checkpoint/--resume/--deadline`, `serve` and `replay`
#8, `--trace/--profile` #9, `--shard` #10); argparse rejects them, and
`fuzz --shard` says so. `--solver` on `apply` and `resilience` consults the
global-solver backend (solve/) first; `apply --json` carries its record
under `engine.solve` and the grow-mode counters under `engine.grow`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import constants as C
from .device import resolve_device
from .plan.capacity import Applier, ApplierOptions
from .report import audit_report, explain_report, report, resilience_report, solve_report

#: exit code for an audit failure: the independent placement auditor
#: caught the primary answer violating its claimed constraints.  When the
#: re-simulation certified, the SHIPPED plan is the re-run's answer — the
#: nonzero code still fires so CI notices the divergence
EXIT_AUDIT = 4


def _interactive_select(names: List[str]) -> List[str]:
    """Multi-select stand-in for survey.Ask (`pkg/apply/apply.go:153-169`)."""
    print("Confirm your apps (comma-separated indices, empty = all):")
    for i, n in enumerate(names):
        print(f"  [{i}] {n}")
    raw = input("> ").strip()
    if not raw:
        return names
    picked = []
    for token in raw.split(","):
        token = token.strip()
        if token.isdigit() and int(token) < len(names):
            picked.append(names[int(token)])
        elif token in names:
            picked.append(token)
    return picked


def _plan_json(plan, resilience: dict = None) -> str:
    """Machine-readable plan summary: the plan, its probes and timings, and
    the engine record (search, bulk, device, and the audit of the shipped
    candidate under `engine.audit`). `resilience` attaches the post-plan
    fault sweep's counters (`--faults`)."""
    from .engine.state import grow_counters_doc

    doc = {
        "success": plan.success,
        "nodes_added": plan.nodes_added,
        "message": plan.message,
        # the port's plans are never interrupted (no deadline or checkpoint)
        "partial": False,
        # grow.* counters (append-only growth): zero for a one-shot apply,
        # but the block is ALWAYS present so consumers need no feature probe
        "engine": {**plan.engine, "grow": grow_counters_doc()} if isinstance(plan.engine, dict)
        else plan.engine,
        "probes": {str(k): v for k, v in sorted(plan.probes.items())},
        "timings": {k: round(v, 3) for k, v in plan.timings.items()},
        "unscheduled": (
            len(plan.result.unscheduled_pods) if plan.result is not None else None
        ),
    }
    if plan.explain:
        # the versioned decision-observability block (explain/, --explain):
        # failure breakdowns + bottleneck analysis
        doc["explain"] = plan.explain
    if resilience is not None:
        doc["resilience"] = resilience
    return json.dumps(doc)


def _audit_failed(doc: Optional[dict]) -> bool:
    """True when an audit record describes a caught divergence — the
    primary answer failed certification (whether or not the re-simulation
    then certified)."""
    return bool(doc) and (bool(doc.get("fallback")) or not doc.get("ok", True))


class _SweepAuditFailure(Exception):
    """The --faults sweep's base placement failed its audit AND the
    serial-exact fallback did not certify either — the hardest audit
    outcome. Carries the audit doc so cmd_apply can surface the
    violations/divergence record and return EXIT_AUDIT."""

    def __init__(self, message: str, audit_doc: dict):
        super().__init__(message)
        self.audit_doc = audit_doc


def _apply_faults_sweep(applier, plan, spec: str, samples: int, seed: int, progress):
    """Post-plan survivability assessment for `apply --faults`: one batched
    fault sweep over the WINNING cluster (base + the clones the plan
    added). Placement for the sweep runs engine-level without preemption
    (the capacity-sweep contract, plan/resilience.py).

    Returns (sweep, base_unplaced, audit_doc): the sweep's drain-from
    placement is independently audited unless opted out, with the
    serial-exact fallback re-placing on failure — a corrupted base would
    silently skew EVERY scenario's verdict."""
    from .audit import checker
    from .core.objects import ResourceTypes
    from . import faults
    from .plan.capacity import new_fake_nodes

    cluster = applier.load_cluster()
    apps = applier.load_apps()
    if plan.nodes_added:
        trial = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
        trial.nodes = list(cluster.nodes) + new_fake_nodes(applier.load_new_node(), plan.nodes_added)
        cluster = trial
    progress(f"fault sweep over the winning cluster ({len(cluster.nodes)} nodes, faults={spec})")
    pc = faults.place_cluster(
        cluster,
        apps,
        extended_resources=applier.opts.extended_resources,
        sched_config=applier._sched_config(),
        device=applier.opts.device,
    )
    audit_doc = None
    if applier.opts.audit is not False:
        pc, audit_doc, hard_fail = checker.audit_placed_cluster(pc, progress)
        if hard_fail is not None:
            raise _SweepAuditFailure(hard_fail, audit_doc)
    # the sweep's own base placement can differ from the plan's (engine-
    # level, simulate() pod order, no preemption) — pods it strands never
    # enter a requeue, so the count MUST ride the output
    base_unplaced = int((pc.nodes < 0).sum())
    if base_unplaced:
        progress(
            f"{base_unplaced} pod(s) do not place in the sweep's base "
            "placement — survivability is assessed over the placed set only"
        )
    scen = faults.generate_scenarios(cluster.nodes, spec, samples=samples, seed=seed)
    return faults.sweep_scenarios(pc, scen), base_unplaced, audit_doc


def _sweep_json_doc(sweep, spec: str, samples: int, seed: int) -> dict:
    doc = dict(sweep.counters())
    doc.update(
        {
            "spec": spec,
            "samples": samples,
            "seed": seed,
            "worst": [[lbl, n] for lbl, n in sweep.worst()],
            "critical_nodes": [[node, n] for node, n in sweep.critical_nodes()],
            "timings": {k: round(v, 3) for k, v in sweep.timings.items()},
        }
    )
    return doc


def cmd_apply(args: argparse.Namespace) -> int:
    opts = ApplierOptions(
        simon_config=args.simon_config,
        default_scheduler_config=args.default_scheduler_config or "",
        use_greed=args.use_greed,
        interactive=args.interactive,
        extended_resources=args.extended_resources or [],
        search=args.search,
        bulk=args.bulk,
        corrected_ds_overhead=args.corrected_ds_overhead,
        audit=args.audit,
        device=args.device,
        explain=args.explain,
        solver=args.solver,
    )

    def fail_early(exc: Exception) -> int:
        # the --json contract holds on every exit: config/load failures
        # still emit a parseable document on stdout
        if args.json:
            print(json.dumps({"success": False, "message": str(exc)}))
        print(exc, file=sys.stderr)
        return 1

    if args.json and opts.interactive:
        # the selection menu and input prompt write to stdout, which --json
        # reserves for the machine-readable document
        return fail_early(
            ValueError("--json and --interactive are mutually exclusive")
        )
    if args.faults and opts.interactive:
        # the post-plan fault sweep re-loads the app list from the config;
        # an interactive selection would silently not apply to it
        return fail_early(ValueError("--faults and --interactive are mutually exclusive"))
    if args.faults:
        # reject a malformed spec BEFORE the plan runs
        from .faults import parse_fault_spec

        try:
            parse_fault_spec(args.faults)
        except ValueError as exc:
            return fail_early(exc)
    try:
        resolve_device(opts.device)
        applier = Applier(opts)
    except (ValueError, FileNotFoundError, RuntimeError) as exc:
        return fail_early(exc)
    select = _interactive_select if opts.interactive else None

    # with --json, stdout is the machine-readable document — progress
    # narration moves to stderr so the stream stays parseable end-to-end
    progress_stream = sys.stderr if args.json else sys.stdout

    def progress(msg: str) -> None:
        print(f"{C.COLOR_YELLOW}{msg}{C.COLOR_RESET}", file=progress_stream)

    try:
        plan = applier.run(select_apps=select, progress=progress)
    except (ValueError, FileNotFoundError, NotImplementedError) as exc:
        return fail_early(exc)
    fault_sweep, fault_base_unplaced, fault_error, fault_audit = None, 0, None, None
    if args.faults and plan.success:
        try:
            fault_sweep, fault_base_unplaced, fault_audit = _apply_faults_sweep(
                applier, plan, args.faults, args.fault_samples, args.fault_seed, progress)
        except _SweepAuditFailure as exc:
            # neither the sweep's base placement nor the serial-exact
            # fallback certified — keep the audit doc for the exit code
            fault_error = str(exc)
            fault_audit = exc.audit_doc
            print(f"fault sweep audit failed: {exc}", file=sys.stderr)
        except ValueError as exc:
            # a failed post-plan sweep must not discard the successful
            # plan: record the error alongside it instead
            fault_error = str(exc)
            print(f"fault sweep failed: {exc}", file=sys.stderr)
    audit_failed = _audit_failed(plan.audit) or _audit_failed(fault_audit)
    if args.json:
        resilience = None
        if fault_sweep is not None:
            resilience = _sweep_json_doc(fault_sweep, args.faults, args.fault_samples, args.fault_seed)
            resilience["base_unplaced"] = fault_base_unplaced
            if fault_audit is not None:
                resilience["audit"] = fault_audit
        elif fault_error is not None:
            resilience = {"error": fault_error}
            if fault_audit is not None:
                resilience["audit"] = fault_audit
        print(_plan_json(plan, resilience=resilience))
        if audit_failed:
            return EXIT_AUDIT
        return 0 if plan.success else 1
    if plan.success:
        print(f"{C.COLOR_GREEN}Success!{C.COLOR_RESET}")
        print(C.COLOR_GREEN, end="")
        print(report(plan.result.node_status, opts.extended_resources))
        print(C.COLOR_RESET, end="")
        if plan.audit:
            color = C.COLOR_RED if _audit_failed(plan.audit) else C.COLOR_GREEN
            print(f"{color}{audit_report(plan.audit)}{C.COLOR_RESET}")
        if plan.solve:
            print(solve_report(plan.solve))
        if plan.timings:
            phases = "  ".join(f"{k}={v:.2f}s" for k, v in plan.timings.items())
            print(f"phase timings: {phases}")
        if _audit_failed(fault_audit):
            print(f"{C.COLOR_RED}{audit_report(fault_audit)}{C.COLOR_RESET}")
        if plan.explain:
            print(explain_report(plan.explain))
        if fault_sweep is not None:
            print(resilience_report(fault_sweep))
            if fault_base_unplaced:
                print(
                    f"{C.COLOR_RED}warning: {fault_base_unplaced} pod(s) "
                    "unplaced before any failure; survivability covers the "
                    f"placed set only{C.COLOR_RESET}"
                )
        if plan.engine:
            eng = " ".join(
                f"{k}={v}" for k, v in plan.engine.items() if not isinstance(v, dict)
            )
            print(f"engine selection: {eng}")
        return EXIT_AUDIT if audit_failed else 0
    print(f"{C.COLOR_RED}{plan.message}{C.COLOR_RESET}")
    if _audit_failed(plan.audit):
        print(f"{C.COLOR_RED}{audit_report(plan.audit)}{C.COLOR_RESET}")
    if plan.explain:
        print(explain_report(plan.explain))
    if plan.result is not None:
        print(C.COLOR_RED, end="")
        print(report(plan.result.node_status, opts.extended_resources))
        print(C.COLOR_RESET, end="")
    return EXIT_AUDIT if _audit_failed(plan.audit) else 1


def cmd_resilience(args: argparse.Namespace) -> int:
    """Survivability assessment / N+k planning over the configured cluster
    (faults/, plan/resilience.py). Default mode drains + requeues every
    generated failure scenario against the as-is cluster; `--plan`
    searches the minimum newNode clone count whose cluster survives them
    (requires `newNode` in the Config CR)."""
    opts = ApplierOptions(
        simon_config=args.simon_config,
        default_scheduler_config=args.default_scheduler_config or "",
        extended_resources=args.extended_resources or [],
        audit=args.audit,
        device=args.device,
    )

    def fail_early(exc: Exception) -> int:
        if args.json:
            print(json.dumps({"success": False, "message": str(exc)}))
        print(exc, file=sys.stderr)
        return 1

    try:
        resolve_device(opts.device)
        applier = Applier(opts)
    except (ValueError, FileNotFoundError, RuntimeError) as exc:
        return fail_early(exc)
    progress_stream = sys.stderr if args.json else sys.stdout

    def progress(msg: str) -> None:
        print(f"{C.COLOR_YELLOW}{msg}{C.COLOR_RESET}", file=progress_stream)

    try:
        cluster = applier.load_cluster()
        apps = applier.load_apps()
        sched_config = applier._sched_config()
        if args.plan:
            from .plan.resilience import plan_resilience

            plan = plan_resilience(
                cluster,
                apps,
                applier.load_new_node(),
                spec=args.faults,
                quantile=args.quantile,
                samples=args.samples,
                seed=args.seed,
                max_new_nodes=args.max_new_nodes,
                extended_resources=opts.extended_resources,
                progress=progress,
                sched_config=sched_config,
                audit=args.audit,
                device=opts.device,
                explain=args.explain,
                solver=args.solver,
            )
            if args.json:
                doc = plan.counters()
                # the port's plans are never interrupted (no deadline)
                doc["partial"] = False
                doc["message"] = plan.message
                doc["probes"] = {str(i): rec for i, rec in sorted(plan.probes.items())}
                if plan.sweep is not None:
                    doc["worst"] = [[lbl, n] for lbl, n in plan.sweep.worst()]
                print(json.dumps(doc))
            else:
                color = C.COLOR_GREEN if plan.success else C.COLOR_RED
                print(f"{color}{plan.message}{C.COLOR_RESET}")
                if plan.success:
                    print(f"minimum nodes added for survivability: {plan.nodes_added}")
                if plan.audit:
                    a_color = C.COLOR_RED if _audit_failed(plan.audit) else C.COLOR_GREEN
                    print(f"{a_color}{audit_report(plan.audit)}{C.COLOR_RESET}")
                if plan.solve:
                    print(solve_report(plan.solve))
                if plan.explain:
                    print(explain_report(plan.explain))
                if plan.sweep is not None:
                    print(resilience_report(plan.sweep))
            if _audit_failed(plan.audit):
                return EXIT_AUDIT
            return 0 if plan.success else 1

        from . import faults
        from .audit import checker

        progress(
            f"placing workloads ({len(cluster.nodes)} nodes), then sweeping "
            f"faults={args.faults}"
        )
        pc = faults.place_cluster(
            cluster,
            apps,
            extended_resources=opts.extended_resources,
            bulk=not args.no_bulk,
            sched_config=sched_config,
            device=opts.device,
        )
        audit_doc = None
        if args.audit is not False:
            # the assessment's drain-from placement feeds EVERY scenario
            # verdict — certify it (serial-exact fallback on failure)
            pc, audit_doc, hard_fail = checker.audit_placed_cluster(pc, progress)
            if hard_fail is not None:
                if args.json:
                    print(json.dumps({"success": False, "message": hard_fail, "audit": audit_doc}))
                print(hard_fail, file=sys.stderr)
                return EXIT_AUDIT
        base_unplaced = int((pc.nodes < 0).sum())
        if base_unplaced:
            progress(
                f"{base_unplaced} pod(s) do not place before any failure — "
                "the sweep assesses only the placed set"
            )
        scen = faults.generate_scenarios(cluster.nodes, args.faults, samples=args.samples,
                                         seed=args.seed)
        sweep = faults.sweep_scenarios(pc, scen)
    except (ValueError, FileNotFoundError, NotImplementedError) as exc:
        return fail_early(exc)
    survived_all = bool(sweep.survival_rate >= 1.0) and base_unplaced == 0
    if args.json:
        doc = _sweep_json_doc(sweep, args.faults, args.samples, args.seed)
        doc["success"] = survived_all
        doc["base_unplaced"] = base_unplaced
        if audit_doc is not None:
            doc["audit"] = audit_doc
        print(json.dumps(doc))
        if _audit_failed(audit_doc):
            return EXIT_AUDIT
        return 0 if survived_all else 1
    color = C.COLOR_GREEN if survived_all else C.COLOR_RED
    print(color, end="")
    print(resilience_report(sweep))
    print(C.COLOR_RESET, end="")
    if _audit_failed(audit_doc):
        print(f"{C.COLOR_RED}{audit_report(audit_doc)}{C.COLOR_RESET}")
    rate = sweep.timings.get("scenarios_per_s", 0.0)
    print(
        f"{len(scen)} scenario(s), {int(sweep.survived.sum())} survived "
        f"({rate:.0f} scenarios/s)"
    )
    if _audit_failed(audit_doc):
        return EXIT_AUDIT
    return 0 if survived_all else 1


def cmd_explain(args: argparse.Namespace) -> int:
    """One engine-level placement of the configured problem, explained
    (explain/). Engine-level deliberately: score attribution's log-prefix
    exactness and the breakdown's end-state semantics both rest on the
    un-surgered placement log (no preemption), the contract the planners'
    probes run under."""
    import numpy as np

    opts = ApplierOptions(
        simon_config=args.simon_config,
        default_scheduler_config=args.default_scheduler_config or "",
        extended_resources=args.extended_resources or [],
        device=args.device,
    )

    def fail_early(exc: Exception) -> int:
        if args.json:
            print(json.dumps({"success": False, "message": str(exc)}))
        print(exc, file=sys.stderr)
        return 1

    try:
        device = resolve_device(opts.device)
        applier = Applier(opts)
    except (ValueError, FileNotFoundError, RuntimeError) as exc:
        return fail_early(exc)
    progress_stream = sys.stderr if args.json else sys.stdout

    def progress(msg: str) -> None:
        print(f"{C.COLOR_YELLOW}{msg}{C.COLOR_RESET}", file=progress_stream)

    try:
        cluster = applier.load_cluster()
        apps = applier.load_apps()
        sched_config = applier._sched_config()
        new_node = None
        try:
            new_node = applier.load_new_node()
        except (ValueError, FileNotFoundError, OSError):
            # the template is optional here: without it the bottleneck block
            # omits the can-another-node-help verdict
            pass
        from .explain import EXPLAIN_VERSION, attribute_scores, build_explain_doc, extras_from_log
        from .faults import place_cluster

        # score attribution's prefix-state exactness (recomputed argmax ==
        # recorded node) is a SERIAL-scan contract — the bulk rounds engine
        # tie-breaks differently — so --scores places with the serial
        # engine (the wavefront keeps it fast and bit-identical)
        use_bulk = not args.no_bulk and args.scores <= 0
        if args.scores > 0 and not args.no_bulk:
            progress("--scores: placing with the serial-equivalent engine "
                     "(score attribution's exactness contract)")
        progress(f"placing workloads ({len(cluster.nodes)} nodes), then explaining the outcome")
        pc = place_cluster(
            cluster,
            apps,
            extended_resources=opts.extended_resources,
            bulk=use_bulk,
            sched_config=sched_config,
            device=device,
        )
        nodes = np.asarray(pc.nodes)
        reasons = np.asarray(pc.reasons)
        unplaced = np.flatnonzero(nodes < 0)
        state = pc.engine.carried_state()
        all_ds = list(cluster.daemon_sets)
        for app in apps:
            all_ds += app.resource.daemon_sets
        doc = {
            "version": EXPLAIN_VERSION,
            "pods": int(len(nodes)),
            "placed": int((nodes >= 0).sum()),
            "unplaced": int(len(unplaced)),
        }
        doc.update(
            build_explain_doc(
                pc.tensors, pc.batch, unplaced, state, nodes, reasons,
                sched_config=sched_config, new_node=new_node,
                daemon_sets=all_ds, top=args.top,
            )
        )
        if args.scores > 0:
            extras = extras_from_log(pc.tensors, nodes, pc.engine.ext_log)
            doc["scores"] = attribute_scores(
                pc.tensors, pc.batch, nodes, extras,
                max_pods=args.scores, sched_config=sched_config, device=device,
            )
    except (ValueError, FileNotFoundError) as exc:
        return fail_early(exc)
    if args.json:
        print(json.dumps(doc))
        return 0
    print(
        f"{C.COLOR_GREEN}{doc['placed']}/{doc['pods']} pods placed{C.COLOR_RESET}"
        + (f" {C.COLOR_RED}({doc['unplaced']} unplaced){C.COLOR_RESET}" if doc["unplaced"] else "")
    )
    print(explain_report(doc))
    return 0


def cmd_fuzz(args: argparse.Namespace) -> int:
    """Differential fuzz / mutation-kill driver (audit/fuzz.py).

    Exit codes: 0 = every case bit-identical and audit-clean (or 100%
    mutation kill); EXIT_AUDIT = a divergence, dirty audit, or missed
    mutation — the finding IS the failure; 1 = the run could not start (a
    reproducer that does not load, the sharded cell, no card)."""
    from .audit import fuzz

    progress_stream = sys.stderr if args.json else sys.stdout

    def progress(msg: str) -> None:
        print(f"{C.COLOR_YELLOW}{msg}{C.COLOR_RESET}", file=progress_stream)

    def refuse(exc: Exception) -> int:
        if args.json:
            print(json.dumps({"ok": False, "message": str(exc)}))
        print(exc, file=sys.stderr)
        return 1

    try:
        device = resolve_device(args.device)
        if args.shard:
            raise NotImplementedError(fuzz.NOT_PORTED_SHARD)
    except (RuntimeError, NotImplementedError) as exc:
        return refuse(exc)

    if args.mutation_kill:
        counters = fuzz.run_mutation_kill(seed=args.seed, per_class=args.per_class, progress=progress,
                                          device=device)
        ok = (
            counters["kill_rate"] >= 1.0
            and counters["classes"] == counters["classes_total"]
            and not counters["missed"]
        )
        if args.json:
            print(json.dumps({"ok": ok, **counters}))
        else:
            color = C.COLOR_GREEN if ok else C.COLOR_RED
            print(
                f"{color}mutation-kill: {counters['killed']}/{counters['tried']} corruptions "
                f"detected across {counters['classes']} classes{C.COLOR_RESET}"
            )
            if counters["missed"]:
                print(f"{C.COLOR_RED}missed: {counters['missed']}{C.COLOR_RESET}")
        return 0 if ok else EXIT_AUDIT

    if args.replay:
        try:
            bad = fuzz.replay_case(args.replay, include_shard=args.shard, device=device)
        except (ValueError, FileNotFoundError) as exc:
            return refuse(exc)
        if args.json:
            doc = {"ok": bad is None, "replay": args.replay}
            if bad is not None:
                doc.update(config=bad[0], kind=bad[1], detail=bad[2])
            print(json.dumps(doc))
        elif bad is None:
            print(f"{C.COLOR_GREEN}replay clean: every engine config bit-identical and "
                  f"audit-clean{C.COLOR_RESET}")
        else:
            print(f"{C.COLOR_RED}replay FAILED on config {bad[0]} ({bad[1]}): {bad[2]}{C.COLOR_RESET}")
        return 0 if bad is None else EXIT_AUDIT

    result = fuzz.run_differential(
        cases=args.cases,
        seed=args.seed,
        n_nodes=args.nodes,
        n_pods=args.pods,
        out_dir=args.out,
        include_shard=args.shard,
        progress=progress,
        device=device,
    )
    if args.json:
        print(json.dumps(result.counters()))
    elif result.ok:
        print(
            f"{C.COLOR_GREEN}fuzz clean: {result.cases} case(s), {result.configs_run} engine-config "
            f"runs, all bit-identical and audit-clean{C.COLOR_RESET}"
        )
    else:
        for f in result.failures:
            repro = f" reproducer={f.reproducer}" if f.reproducer else ""
            print(f"{C.COLOR_RED}seed {f.seed} config {f.config}: {f.kind} — {f.detail}{repro}"
                  f"{C.COLOR_RESET}")
    return 0 if result.ok else EXIT_AUDIT


def _add_audit_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--audit",
        dest="audit",
        action="store_true",
        default=None,
        help="certify the accepted placement through the independent "
        "auditor (default: on); an audit failure re-simulates, ships the "
        f"certified answer, and exits with code {EXIT_AUDIT}",
    )
    p.add_argument(
        "--no-audit",
        dest="audit",
        action="store_false",
        help="skip the independent placement audit (the plan ships uncertified)",
    )


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where every simulation runs (default: cuda, the hand-written "
        "kernels on the card; cpu runs their plain PyTorch versions)",
    )


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
    """Global-solver backend opt-in shared by the planning commands
    (solve/). Advisory mode: the solver PROPOSES a placement at a
    certified-minimal node count, the independent auditor DISPOSES — any
    rejected or uncertified answer falls back to the exact search with at
    most a warm-start lower bound."""
    p.add_argument(
        "--solver",
        dest="solver",
        action="store_true",
        default=None,
        help="consult the global-solver planning backend first: one convex "
        "relaxation over ALL candidate node counts replaces the "
        "doubling+bisection capacity search; the rounded placement ships "
        "only when the independent auditor certifies it AND minimality is "
        "proven by an infeasibility certificate at the count below "
        "(default: off; the '--json' engine block records which backend "
        "answered)",
    )
    p.add_argument(
        "--no-solver",
        dest="solver",
        action="store_false",
        help="never consult the global-solver backend (exact search only)",
    )


def _add_explain_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--explain",
        action="store_true",
        help="attach the decision-observability block to the result: "
        "kube-scheduler-style per-stage failure breakdowns for every "
        "unplaced pod ('0/N nodes are available: 3 insufficient ..., 5 "
        "node(s) didn't match ...') and a binding-constraint bottleneck "
        "analysis (what to buy) for infeasible plans; rides --json under "
        "'explain' and the report as extra tables (off = no extra launch)",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simtpu_torch",
        description="cluster simulator and capacity planner (the PyTorch/CUDA "
        "port of simtpu)",
    )
    sub = parser.add_subparsers(dest="command")
    apply_p = sub.add_parser("apply", help="simulate deploying applications in a cluster")
    apply_p.add_argument(
        "-f", "--simon-config", required=True, help="path of simon config (required)"
    )
    apply_p.add_argument(
        "-s",
        "-d",
        "--default-scheduler-config",
        help="path of scheduler-config overrides",
    )
    apply_p.add_argument(
        "-g",
        "--use-greed",
        action="store_true",
        help="use greed algorithm to queue pods (accepted for parity; the "
        "reference never wires this to its scheduler either)",
    )
    apply_p.add_argument(
        "-i", "--interactive", action="store_true", help="interactively choose apps"
    )
    apply_p.add_argument(
        "-e",
        "--extended-resources",
        nargs="*",
        choices=["open-local", "gpu"],
        help="show extended resources in the report (open-local, gpu)",
    )
    apply_p.add_argument(
        "--search",
        choices=["binary", "linear", "incremental"],
        default=None,
        help="min-node-add search strategy (default: auto by problem size; "
        "linear = reference-exact walk; incremental = one tensorization + "
        "completion probes + fresh verification, the fast path for large "
        "clusters)",
    )
    apply_p.add_argument(
        "--bulk",
        dest="bulk",
        action="store_true",
        default=None,
        help="place replica runs with the bulk rounds engine (default: auto "
        "by problem size; faster on large app lists; tie-breaking may "
        "differ from the serial scan)",
    )
    apply_p.add_argument(
        "--no-bulk",
        dest="bulk",
        action="store_false",
        help="force the serial scan engine even at scale",
    )
    apply_p.add_argument(
        "--corrected-ds-overhead",
        action="store_true",
        help="account daemonset overhead on the template node in the "
        "can-ever-fit diagnostic (the reference pins its probe pod to a node "
        "named 'simon', so the overhead silently contributes nothing)",
    )
    apply_p.add_argument(
        "--json",
        action="store_true",
        help="print a machine-readable JSON plan summary (success, nodes "
        "added, probes, timings, engine and audit record) instead of the "
        "report tables",
    )
    apply_p.add_argument(
        "--faults",
        metavar="SPEC",
        default=None,
        help="after a successful plan, sweep failure scenarios over the "
        "winning cluster: comma-separated k=<int>[:<samples>] terms and "
        "domain outages (zone, rack, host, label:<key>)",
    )
    apply_p.add_argument(
        "--fault-samples",
        type=int,
        default=256,
        metavar="N",
        help="sample budget per k>=2 fault term (default 256)",
    )
    apply_p.add_argument(
        "--fault-seed",
        type=int,
        default=0,
        metavar="SEED",
        help="deterministic seed for sampled fault scenarios (default 0)",
    )
    _add_audit_flags(apply_p)
    _add_device_flag(apply_p)
    _add_explain_flag(apply_p)
    _add_solver_flags(apply_p)
    apply_p.set_defaults(func=cmd_apply)

    res_p = sub.add_parser(
        "resilience",
        help="fault-injection survivability: drain + requeue batched "
        "failure scenarios (and optionally plan N+k capacity)",
        description="Not ported yet: --checkpoint/--resume/--deadline "
        "(ROADMAP queue 1 #8), --trace/--profile (#9).",
    )
    res_p.add_argument(
        "-f", "--simon-config", required=True, help="path of simon config (required)"
    )
    res_p.add_argument(
        "-d",
        "--default-scheduler-config",
        help="path of scheduler-config overrides",
    )
    res_p.add_argument(
        "-e",
        "--extended-resources",
        nargs="*",
        choices=["open-local", "gpu"],
        help="extended resources to model (open-local, gpu)",
    )
    res_p.add_argument(
        "--faults",
        metavar="SPEC",
        default="k=1",
        help="failure model: comma-separated k=<int>[:<samples>] terms and "
        "domain outages (zone, rack, host, label:<key>); default k=1 = "
        "every single-node outage",
    )
    res_p.add_argument(
        "--samples",
        type=int,
        default=256,
        metavar="N",
        help="sample budget per k>=2 fault term (default 256; exhaustive "
        "when the combination count fits)",
    )
    res_p.add_argument(
        "--seed",
        type=int,
        default=0,
        metavar="SEED",
        help="deterministic seed for sampled scenarios (default 0)",
    )
    res_p.add_argument(
        "--quantile",
        type=float,
        default=1.0,
        metavar="Q",
        help="with --plan: accept a candidate when at least this fraction "
        "of scenarios fully re-places (default 1.0 = every scenario)",
    )
    res_p.add_argument(
        "--plan",
        action="store_true",
        help="search the minimum newNode clone count whose cluster "
        "survives the failure model (requires newNode in the Config CR)",
    )
    res_p.add_argument(
        "--max-new-nodes",
        type=int,
        default=C.MAX_NUM_NEW_NODE,
        metavar="N",
        help=f"--plan search ceiling (default {C.MAX_NUM_NEW_NODE})",
    )
    res_p.add_argument(
        "--no-bulk",
        action="store_true",
        help="place the base workloads with the serial scan engine instead "
        "of the bulk rounds engine",
    )
    res_p.add_argument(
        "--json",
        action="store_true",
        help="print machine-readable survivability counters (scenarios, "
        "survived, fault_scenarios_per_s, worst scenarios, critical nodes) "
        "instead of the report tables",
    )
    _add_audit_flags(res_p)
    _add_device_flag(res_p)
    _add_explain_flag(res_p)
    _add_solver_flags(res_p)
    res_p.set_defaults(func=cmd_resilience)

    exp_p = sub.add_parser(
        "explain",
        help="explain one placement: per-stage failure breakdowns, "
        "per-plugin score attribution, bottleneck analysis",
        description="Decision observability: place the configured cluster + "
        "apps through ONE engine (no capacity search, no preemption) and "
        "explain the outcome. Every unplaced pod gets the kube-scheduler-"
        "style status string with per-stage node-elimination counts and "
        "witness nodes; --scores N additionally decomposes the first N "
        "placed pods' winning scores into per-plugin terms with the "
        "runner-up node and margin; the bottleneck section names the "
        "binding resource and whether another template node can ever help.",
    )
    exp_p.add_argument("-f", "--simon-config", required=True, help="path of simon config (required)")
    exp_p.add_argument("-d", "--default-scheduler-config", help="path of scheduler-config overrides")
    exp_p.add_argument(
        "-e",
        "--extended-resources",
        nargs="*",
        choices=["open-local", "gpu"],
        help="extended resources to model (open-local, gpu)",
    )
    exp_p.add_argument(
        "--scores",
        type=int,
        default=0,
        metavar="N",
        help="attribute the first N placed pods' scores (per-plugin "
        "decomposition, runner-up, margin; default 0 = off — each pod costs "
        "one log-prefix state rebuild; forces the serial-equivalent engine: "
        "attribution exactness is a serial-scan contract)",
    )
    exp_p.add_argument(
        "--top",
        type=int,
        default=10,
        metavar="K",
        help="distinct failure shapes kept in the breakdown (default 10; "
        "truncation is reported, never silent)",
    )
    exp_p.add_argument(
        "--no-bulk",
        action="store_true",
        help="place with the serial scan engine instead of the bulk rounds engine",
    )
    exp_p.add_argument(
        "--json",
        action="store_true",
        help="print the versioned explain document (the same block apply "
        "--explain --json embeds) instead of the report tables",
    )
    _add_device_flag(exp_p)
    exp_p.set_defaults(func=cmd_explain)

    fuzz_p = sub.add_parser(
        "fuzz",
        help="differential fuzz the engine-config matrix against the serial "
        "baseline + the independent auditor",
        description="Seeded differential fuzzing: generate gnarly "
        "spec/cluster cases, place each across the engine-config matrix "
        "(wavefront on/off x compact carry on/off) and assert bit-identical, "
        "audit-clean placements. Failing cases shrink to a minimal "
        "reproducer YAML under --out. --mutation-kill instead corrupts "
        "accepted placements across every corruption class and asserts the "
        "auditor flags 100% of them. Not ported: the injected-OOM backoff "
        "cell (ROADMAP queue 1 #8) and the sharded cell, --shard (#10).",
    )
    fuzz_p.add_argument("--cases", type=int, default=16, metavar="N",
                        help="generated cases for the differential mode (default 16)")
    fuzz_p.add_argument("--seed", type=int, default=0, metavar="SEED",
                        help="base seed; case i draws from seed + 1000*i (default 0)")
    fuzz_p.add_argument("--nodes", type=int, default=32, metavar="N",
                        help="synthetic cluster size per case (default 32)")
    fuzz_p.add_argument("--pods", type=int, default=160, metavar="N",
                        help="pods per case (default 160)")
    fuzz_p.add_argument("--out", metavar="DIR", default="",
                        help="write auto-shrunk minimal reproducer YAMLs for failing cases under "
                        "DIR (skipping shrink when unset)")
    fuzz_p.add_argument("--replay", metavar="FILE",
                        help="re-run one reproducer YAML (written by --out) across the "
                        "engine-config matrix instead of generating cases")
    fuzz_p.add_argument("--mutation-kill", action="store_true",
                        help="corrupt accepted placements across every corruption class "
                        "(invalid node, overcommit, affinity/anti-affinity/spread breaks, port "
                        "conflicts, illegal evictions) and assert the auditor flags every one")
    fuzz_p.add_argument("--per-class", type=int, default=4, metavar="N",
                        help="mutation trials per corruption class (default 4)")
    fuzz_p.add_argument("--shard", dest="shard", action="store_true", default=None,
                        help="the sharded matrix cell: not ported (ROADMAP queue 1 #10), refused")
    fuzz_p.add_argument("--no-shard", dest="shard", action="store_false",
                        help="skip the sharded matrix cell (one card never runs it)")
    fuzz_p.add_argument("--json", action="store_true",
                        help="print machine-readable counters instead of progress text")
    _add_device_flag(fuzz_p)
    fuzz_p.set_defaults(func=cmd_fuzz)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
