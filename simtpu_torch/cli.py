"""The port's command line: `python -m simtpu_torch.cli apply`.

The `apply` command of the JAX package's `simtpu` CLI (which mirrors the
reference's `simon apply`, `cmd/apply/apply.go:26-37`): plan the minimum
number of template nodes that deploys the app list, print the report
tables (or, with `--json`, the machine-readable plan), and exit 0 on a
plan, 1 on failure, 4 when the auditor caught a divergence. Every
simulation runs on `--device` (default `cuda`; `cpu` runs the plain
PyTorch path). The JAX CLI's other commands and apply flags are not
ported yet (ROADMAP queue 1); argparse rejects them.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import constants as C
from .device import resolve_device
from .plan.capacity import Applier, ApplierOptions
from .report import audit_report, report

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


def _plan_json(plan) -> str:
    """Machine-readable plan summary: the plan, its probes and timings, and
    the engine record (search, bulk, device, and the audit of the shipped
    candidate under `engine.audit`)."""
    doc = {
        "success": plan.success,
        "nodes_added": plan.nodes_added,
        "message": plan.message,
        # the port's plans are never interrupted (no deadline or checkpoint)
        "partial": False,
        "engine": plan.engine,
        "probes": {str(k): v for k, v in sorted(plan.probes.items())},
        "timings": {k: round(v, 3) for k, v in plan.timings.items()},
        "unscheduled": (
            len(plan.result.unscheduled_pods) if plan.result is not None else None
        ),
    }
    return json.dumps(doc)


def _audit_failed(doc: Optional[dict]) -> bool:
    """True when an audit record describes a caught divergence — the
    primary answer failed certification (whether or not the re-simulation
    then certified)."""
    return bool(doc) and (bool(doc.get("fallback")) or not doc.get("ok", True))


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
    if args.json:
        print(_plan_json(plan))
        if _audit_failed(plan.audit):
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
        if plan.timings:
            phases = "  ".join(f"{k}={v:.2f}s" for k, v in plan.timings.items())
            print(f"phase timings: {phases}")
        if plan.engine:
            eng = " ".join(
                f"{k}={v}" for k, v in plan.engine.items() if not isinstance(v, dict)
            )
            print(f"engine selection: {eng}")
        return EXIT_AUDIT if _audit_failed(plan.audit) else 0
    print(f"{C.COLOR_RED}{plan.message}{C.COLOR_RESET}")
    if _audit_failed(plan.audit):
        print(f"{C.COLOR_RED}{audit_report(plan.audit)}{C.COLOR_RESET}")
    if plan.result is not None:
        print(C.COLOR_RED, end="")
        print(report(plan.result.node_status, opts.extended_resources))
        print(C.COLOR_RESET, end="")
    return EXIT_AUDIT if _audit_failed(plan.audit) else 1


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
        "--audit",
        dest="audit",
        action="store_true",
        default=None,
        help="certify the accepted placement through the independent "
        "auditor (default: on); an audit failure re-simulates, ships the "
        f"certified answer, and exits with code {EXIT_AUDIT}",
    )
    apply_p.add_argument(
        "--no-audit",
        dest="audit",
        action="store_false",
        help="skip the independent placement audit (the plan ships uncertified)",
    )
    apply_p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where every simulation runs (default: cuda, the hand-written "
        "kernels on the card; cpu runs their plain PyTorch versions)",
    )
    apply_p.set_defaults(func=cmd_apply)
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
