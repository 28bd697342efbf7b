"""Public simulation API of the port: the serial path behind `simulate()`.

The counterpart of the JAX package's `api.py` serial path: `Simulator`
with `run_cluster` / `schedule_app`, priority preemption in waves (the
DefaultPreemption PostFilter analog, with PodDisruptionBudgets), and the
one-shot `simulate()`. The engine runs on `device` (default `cuda`;
`device="cpu"` selects the plain PyTorch path explicitly).

`simulate(audit=True)` runs the independent placement auditor
(`audit/checker.py`) over the final state before the simulator closes;
`simulate(explain=True)` attaches the decision-observability block
(`explain/`: per-stage failure breakdowns through K20, the bottleneck
analysis). Not in this port yet (ROADMAP queue 1): precompile (#10) and
the tracing and profiling options (#9) of the JAX package's `simulate()`.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from . import constants as C
from .core.objects import (
    AppResource,
    NodeStatus,
    PreemptedPod,
    ResourceTypes,
    SimulateResult,
    UnscheduledPod,
    annotations_of,
    deep_copy,
    name_of,
    namespace_of,
    pod_priority,
    set_annotation,
    set_label,
    shallow_pod_copy,
)
from .core.quantity import parse_quantity
from .core.tensorize import Tensorizer, _group_of_pod
from .device import resolve_device
from .engine.scan import (
    FAIL_ATTACH,
    FAIL_GPU,
    FAIL_INTERPOD,
    FAIL_PORTS,
    FAIL_RESOURCES,
    FAIL_SPREAD,
    FAIL_STORAGE,
    FAIL_VOLUME,
    REASON_TEXT,
    Engine,
)
from .workloads.expand import (
    get_valid_pods_exclude_daemonset,
    make_valid_pods_by_daemonset,
)

# Failure classes where evicting lower-priority pods can help — the analog
# of DefaultPreemption's PostFilter eligibility.
_PREEMPTIBLE_REASONS = {
    FAIL_RESOURCES,
    FAIL_PORTS,
    FAIL_STORAGE,
    FAIL_GPU,
    FAIL_INTERPOD,
    FAIL_SPREAD,
    FAIL_VOLUME,
    FAIL_ATTACH,
}
log = logging.getLogger("simtpu_torch.api")

#: reason suffix for pods finalized by the preemption wave cap — a tripped
#: cap is a termination-insurance abort, not a genuine verify failure, and
#: must be distinguishable in the report (ADVICE r5, `waves_left`)
PREEMPT_WAVE_CAP_NOTE = "preemption retry aborted: wave cap exhausted"


def _anti_topo_keys(pod: dict) -> set:
    """topologyKeys of the pod's REQUIRED anti-affinity terms."""
    from .core.objects import pod_affinity

    anti = pod_affinity(pod).get("podAntiAffinity") or {}
    return {
        t.get("topologyKey")
        for t in anti.get("requiredDuringSchedulingIgnoredDuringExecution") or []
        if t.get("topologyKey")
    }


def _head_affinity_depends_on(pod: dict, wave_pods) -> bool:
    """True when `pod`'s REQUIRED positive pod-affinity selects another
    wave pod's labels — the case where finalizing the pod's retry failure
    would be unsound: a fresh-retried head verifies FIRST in its wave, so
    its verdict never saw the selected pod placed, and that pod (demoted or
    later in the wave) may yet place.  Mirrors the demote predicate's
    conservatism (namespace scoping is deliberately ignored: a false
    positive just defers finality, bounded by the wave cap; a false
    negative would finalize a failure the serial evict/retry order could
    avoid — ADVICE r5 #3)."""
    from .core.match import match_label_selector
    from .core.objects import labels_of, pod_affinity

    aff = pod_affinity(pod).get("podAffinity") or {}
    terms = aff.get("requiredDuringSchedulingIgnoredDuringExecution") or []
    if not terms:
        return False
    return any(
        match_label_selector(t.get("labelSelector"), labels_of(dp))
        for t in terms
        for dp in wave_pods
    )


def _restore_topo_keys(pod: dict) -> set:
    """topologyKeys along which re-adding previously evicted pods can turn
    this pod's filter verdict from pass to fail on a node the victims do
    NOT occupy.  Only domain-scoped negative constraints can: required pod
    anti-affinity and DoNotSchedule topology spread (a restore raises
    domain counts).  Positive required affinity can't — restores only add
    satisfiers."""
    from .core.objects import pod_topology_spread_constraints

    keys = _anti_topo_keys(pod)
    keys |= {
        c.get("topologyKey")
        for c in pod_topology_spread_constraints(pod)
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") == "DoNotSchedule"
        and c.get("topologyKey")
    }
    return keys



def _sort_app_pods(pods: List[dict], nodes: Sequence[dict] = (), use_greed: bool = False) -> List[dict]:
    """Stable emulation of the reference's app-pod ordering: AffinityQueue
    (nodeSelector pods first) then TolerationQueue (tolerations pods first);
    with `use_greed`, GreedQueue's DRF dominant-share order first."""
    from .algo import affinity_sort, greed_sort, toleration_sort

    if use_greed:
        pods = greed_sort(pods, nodes)
    return toleration_sort(affinity_sort(pods))


class Simulator:
    """One in-memory cluster simulation on one device."""

    #: slack term of the preemption wave-loop termination cap
    #: (`_preempt_failed_batch`): waves_left = WAVE_CAP_SLACK + 2 * len(failed)
    WAVE_CAP_SLACK = 4

    def __init__(
        self,
        extra_resources: Sequence[str] = (),
        use_greed: bool = False,
        sched_config=None,
        device=None,
        engine_factory=None,
    ):
        self._extra_resources = extra_resources
        #: engine_factory(tensorizer, device) -> engine (None = Engine)
        self._engine_factory = engine_factory or Engine
        self._use_greed = use_greed
        self._sched_config = sched_config
        self._device = resolve_device(device)
        self._tensorizer: Optional[Tensorizer] = None
        self._engine: Optional[Engine] = None
        self._nodes: List[dict] = []
        self._scheduled: List[dict] = []  # placed pods, nodeName set; parallel
        self._placed_prio: List[float] = []  # ... to the engine placement log
        # ... and whether each entry was bound via spec.nodeName before
        # scheduling
        self._placed_forced: List[bool] = []
        self._preempted: List[PreemptedPod] = []
        self._unscheduled: List[UnscheduledPod] = []
        #: the fail code of each unscheduled pod, parallel to _unscheduled
        self._unscheduled_codes: List[int] = []
        self._pdbs: List[dict] = []

    def run_cluster(self, cluster: ResourceTypes) -> SimulateResult:
        """Install nodes and schedule the cluster's own pods."""
        self._nodes = [deep_copy(n) for n in cluster.nodes]
        # cluster PDBs constrain preemption (app PDBs are never created)
        self._pdbs = [deep_copy(p) for p in cluster.pod_disruption_budgets]
        self._tensorizer = Tensorizer(
            self._nodes,
            self._extra_resources,
            storage_classes=list(cluster.storage_classes),
            services=list(cluster.services),
            pvcs=list(cluster.persistent_volume_claims),
            pvs=list(cluster.persistent_volumes),
        )
        self._engine = self._engine_factory(self._tensorizer, self._device)
        self._engine.sched_config = self._sched_config
        self._schedule_pods(cluster.pods)
        return self._result()

    def schedule_app(self, app: AppResource) -> SimulateResult:
        """Expand one app into pods and schedule them in order (only the
        app's pods enter the simulation, as in the reference)."""
        pods = get_valid_pods_exclude_daemonset(app.resource)
        for ds in app.resource.daemon_sets:
            pods.extend(make_valid_pods_by_daemonset(ds, self._nodes))
        for pod in pods:
            set_label(pod, C.LABEL_APP_NAME, app.name)
        pods = _sort_app_pods(pods, self._nodes, self._use_greed)
        self._schedule_pods(pods)
        return self._result()

    def close(self) -> None:
        self._tensorizer = None
        self._engine = None

    def _record_placed(self, pod: dict, node_idx: int, gpu_shares, forced: bool = False) -> None:
        self._scheduled.append(
            record_placed_pod(pod, self._nodes[node_idx]["metadata"]["name"], gpu_shares)
        )
        self._placed_prio.append(pod_priority(pod))
        self._placed_forced.append(forced)

    def _record_failed(self, pod: dict, reason: int, note: str = "") -> None:
        msg = REASON_TEXT[int(reason)]
        if note:
            msg = f"{msg} ({note})"
        self._unscheduled.append(
            UnscheduledPod(
                pod=pod,
                reason=(
                    f"failed to schedule pod ({namespace_of(pod)}/{name_of(pod)}): "
                    f"Unschedulable: 0/{len(self._nodes)} nodes are available: {msg}"
                ),
            )
        )
        self._unscheduled_codes.append(int(reason))

    def _schedule_pods(self, pods: Sequence[dict]) -> None:
        # only default-scheduler pods enter the scheduling path; pods bound
        # via spec.nodeName occupy capacity regardless of schedulerName
        pods = [
            p
            for p in pods
            if (p.get("spec") or {}).get("nodeName")
            or ((p.get("spec") or {}).get("schedulerName") or C.DEFAULT_SCHEDULER_NAME)
            == C.DEFAULT_SCHEDULER_NAME
        ]
        if not pods:
            return
        batch = self._tensorizer.add_pods(pods)
        nodes, reasons, extras = self._engine.place(batch)
        # record every placement FIRST, so the priorities stay parallel to
        # the engine's placement log; preemption then runs against a
        # consistent view
        failed = []
        for i, (pod, node_idx, reason) in enumerate(zip(batch.pods, nodes, reasons)):
            if node_idx >= 0:
                self._record_placed(
                    pod, node_idx, extras["gpu_shares"][i], forced=bool(batch.forced[i])
                )
            else:
                failed.append((pod, int(reason)))
        self._preempt_failed_batch(failed)

    # -- preemption (DefaultPreemption PostFilter analog) -------------------

    def _build_preempt_model(self) -> dict:
        """Whole-log host arrays shared by a preemption WAVE: priorities,
        per-entry node/request/extended usage, and per-node usage sums.
        Built once per wave (O(log)) and updated incrementally per victim
        proposal — the r3 implementation rebuilt all of it per preemption,
        which dominated at 10^5-entry logs (VERDICT r3 weak #1)."""
        tz = self._tensorizer
        alloc = tz.alloc
        r = alloc.shape[1]
        eng = self._engine

        def padded(row):
            return np.pad(row, (0, r - row.shape[0])) if row.shape[0] < r else row

        placed_req = (
            np.stack([padded(q) for q in eng.placed_req])
            if eng.placed_req
            else np.zeros((0, r), np.float32)
        )
        placed_nodes = np.asarray(eng.placed_node, np.int64)
        used = np.zeros_like(alloc)
        np.add.at(used, placed_nodes, placed_req)
        ext_log = eng.ext_log
        m = len(placed_nodes)
        gpu_mem_log = (
            np.asarray(ext_log["gpu_mem"], np.float32) if m else np.zeros(0, np.float32)
        )
        gpu_use_log = (
            np.asarray(ext_log["gpu_shares"], np.float32).sum(axis=1) * gpu_mem_log
            if m
            else np.zeros(0, np.float32)
        )
        vg_use_log = (
            np.asarray(ext_log["vg_alloc"], np.float32).sum(axis=1)
            if m
            else np.zeros(0, np.float32)
        )
        sd_any_log = (
            np.asarray(ext_log["sdev_take"], bool).any(axis=1)
            if m
            else np.zeros(0, bool)
        )
        n_nodes = len(self._nodes)
        gpu_used_n = np.zeros(n_nodes, np.float32)
        np.add.at(gpu_used_n, placed_nodes, gpu_use_log)
        vg_used_n = np.zeros(n_nodes, np.float32)
        np.add.at(vg_used_n, placed_nodes, vg_use_log)
        return {
            "prios": np.asarray(self._placed_prio, np.float64),
            "placed_nodes": placed_nodes,
            "placed_req": placed_req,
            "placed_groups": np.asarray(eng.placed_group, np.int32),
            "used": used,
            "gpu_mem_log": gpu_mem_log,
            "gpu_use_log": gpu_use_log,
            "vg_use_log": vg_use_log,
            "sd_any_log": sd_any_log,
            "gpu_used_n": gpu_used_n,
            "vg_used_n": vg_used_n,
            "evicted": np.zeros(m, bool),
        }

    def _preempt_failed_batch(self, failed) -> None:
        """Preempt for a whole batch of failed pods with BATCHED device work.

        Mirrors the DefaultPreemption flow per pod — find candidate nodes
        where removing victims plausibly fits the pod, pick the node
        minimizing (PDB violations, highest victim priority, summed
        priorities, victim count; `defaultpreemption/default_preemption.go`
        pickOneNodeForPreemption) — but executes in WAVES so a thousand
        preemptions cost a handful of device dispatches instead of three
        each (VERDICT r3 task 2, the same batching the leftover probes got
        in r3):

        1. every pending pod's victim set is proposed HOST-side against a
           shared whole-log model updated incrementally per proposal (so
           later proposals see earlier evictions);
        2. all proposed evictions apply as ONE incremental log delta;
        3. all preemptors re-run the real filter pipeline as ONE batched
           placement (sequentially exact within the batch, like the serial
           engine's retry order);
        4. on the first verify failure f: pods before f commit — EXCEPT
           pods whose verdict may have ridden f's evictions (their node
           hosts one of f's victims, or a domain-scoped negative
           constraint — theirs or a victim's — could flip when the victims
           return; committing them would break a no-overcommit /
           hard-constraint invariant), which are demoted and re-verified
           next wave with their evictions kept; pod f's
           evictions are restored and the pod re-proposes FRESH next wave
           (a fresh proposal runs against the wave-start model, i.e. the
           true log state, so its verify verdict is serial-authoritative —
           a second failure is final and the pod records its original
           reason); later pods' placements are reverted (they saw a state
           missing f's restored victims) and re-verify next wave with
           their evictions kept.

        The cheap host model only *proposes* sets — the batched retry
        verifies, so optimism (e.g. two preemptors counting the same free
        CPU) self-corrects exactly like the serial evict/retry/undo did.
        Victims are reported in `SimulateResult.preempted_pods`, not
        re-queued."""
        if not failed:
            return
        # (pod, reason, saved victim records or None, fresh-retry used)
        pending = [(pod, reason, None, False) for pod, reason in failed]
        # heads already granted the affinity-dependence finality deferral
        # (ADVICE r5 #3): one deferral per pod — enough for a placeable
        # anchor to land before the head's next fresh attempt, while two
        # mutually-dependent unplaceable pods finalize with their true
        # reasons instead of ping-ponging into the wave cap
        affinity_deferred: set = set()
        # termination insurance: the retried-finality rule below only
        # finalizes FRESH-attempt failures, so an adversarial geometry
        # could in principle ping-pong demotions between already-retried
        # pods; the serial flow's work is O(failed), so is this cap
        # (WAVE_CAP_SLACK is an attribute so tests can force the abort path)
        waves_left = self.WAVE_CAP_SLACK + 2 * len(failed)
        while pending:
            waves_left -= 1
            if waves_left < 0:
                # termination-insurance abort: these pods were still PENDING
                # (the serial evict/retry order might yet have placed them),
                # so their original failure reason is stale — tag it so a
                # tripped cap is observable, and say how many pods it cut off
                log.warning(
                    "preemption wave cap exhausted with %d pod(s) still "
                    "pending; recording them unscheduled with their original "
                    "failure reasons",
                    len(pending),
                )
                n_aborted = len(pending)
                for pod, reason, preev, _ in pending:
                    if preev:
                        self._restore_victims(preev)
                    self._record_failed(
                        pod,
                        reason,
                        note=(
                            f"{PREEMPT_WAVE_CAP_NOTE}, "
                            f"{n_aborted} pod(s) unresolved"
                        ),
                    )
                return
            model = self._build_preempt_model()
            wave = []  # (pod, reason, new victims, prior records, retried)
            for pod, reason, preev, retried in pending:
                if preev is not None:
                    # evicted in an earlier wave; only re-verification left
                    wave.append((pod, reason, [], preev, retried))
                    continue
                victims = self._propose_victims(pod, reason, model)
                if victims is None:
                    self._record_failed(pod, reason)
                else:
                    wave.append((pod, reason, victims, None, retried))
            if not wave:
                return
            owner = {}
            for w, (_, _, victims, _, _) in enumerate(wave):
                for i in victims:
                    owner[i] = w
            saved_per_pod = [
                list(preev) if preev is not None else []
                for (_, _, _, preev, _) in wave
            ]
            all_v = sorted(owner)
            if all_v:
                saved = self._engine.remove_placements(all_v)
                for i, entry in zip(saved["indices"], saved["entries"]):
                    saved_per_pod[owner[i]].append(
                        (
                            entry,
                            self._scheduled[i],
                            self._placed_prio[i],
                            self._placed_forced[i],
                        )
                    )
                for i in reversed(saved["indices"]):
                    del self._scheduled[i]
                    del self._placed_prio[i]
                    del self._placed_forced[i]
            probe = self._tensorizer.add_pods([p for p, _, _, _, _ in wave])
            log_base = len(self._engine.placed_node)
            nodes, _, extras = self._engine.place(probe)
            nodes = np.asarray(nodes)
            placed_mask = nodes >= 0
            fail_pos = np.flatnonzero(~placed_mask)
            f = int(fail_pos[0]) if len(fail_pos) else len(wave)
            ranks = np.cumsum(placed_mask) - 1  # log rank of each placed pod
            # A pod before f may have verify-landed on a placement that only
            # passed because of f's (about to be restored) evictions — the
            # batched placement saw ALL wave evictions, not just the pod's
            # own.  Committing it while restoring f's victims would silently
            # violate an invariant the serial evict/retry/undo flow never
            # can: node resource overcommit (pod sits on a victim's node),
            # a required anti-affinity or DoNotSchedule-spread verdict that
            # flips when the victims return (domain-scoped — demote when the
            # pod's node shares a relevant topology domain with a victim's
            # node), or a restored victim's own required anti-affinity now
            # matching the new pod (same domain test, victim's keys).
            # Demote those pods instead: skip their commit, drop their log
            # entries, and re-verify them next wave with their own evictions
            # kept (advisor finding, round 4).
            # An eviction is PERMANENT only once its proposer commits.  The
            # victims of f (restored this wave), of after-f pods, and of
            # demoted pods (carried as preev, restorable in a LATER wave or
            # the cap-abort path) are all provisional — so the demote scan
            # runs to a fixpoint: demoting a pod makes its own victims
            # provisional too.
            demote: set = set()
            if f < len(wave):

                def _labels(idx: int) -> dict:
                    meta = self._nodes[idx].get("metadata") or {}
                    return meta.get("labels") or {}

                prov_nodes: set = set()
                prov_victims: list = []

                def _absorb(records):
                    for entry, vpod, _prio, _forced in records:
                        prov_nodes.add(entry[1])
                        prov_victims.append(
                            (_labels(entry[1]), _anti_topo_keys(vpod))
                        )

                for w in range(f, len(wave)):
                    _absorb(saved_per_pod[w])
                # hoisted per-pod spec parses / label lookups: the fixpoint
                # below rescans range(f) once per demotion
                w_node = [int(nodes[w]) for w in range(f)]
                w_keys = [_restore_topo_keys(wave[w][0]) for w in range(f)]
                w_labels = [_labels(n) for n in w_node]
                changed = True
                while changed:
                    changed = False
                    for w in range(f):
                        if w in demote:
                            continue
                        rides = w_node[w] in prov_nodes
                        if not rides:
                            wl = w_labels[w]
                            rides = any(
                                k in wl and k in vl and wl[k] == vl[k]
                                for vl, vkeys in prov_victims
                                for k in (*w_keys[w], *vkeys)
                            )
                        if rides:
                            demote.add(w)
                            _absorb(saved_per_pod[w])
                            changed = True
            for w in range(f):
                if w in demote:
                    continue
                pod = wave[w][0]
                who = f"{namespace_of(pod)}/{name_of(pod)}"
                for _, vpod, _prio, _forced in saved_per_pod[w]:
                    self._preempted.append(
                        PreemptedPod(
                            pod=vpod,
                            preempted_by=who,
                            node=vpod["spec"].get("nodeName", ""),
                        )
                    )
                self._record_placed(pod, int(nodes[w]), extras["gpu_shares"][w])
            if f == len(wave):
                return
            # demoted pods and pods after f placed against a state that is
            # about to change (f's victims return) — revert their log
            # entries; they re-verify next wave
            revert = [
                log_base + int(ranks[w])
                for w in list(demote) + list(range(f + 1, len(wave)))
                if placed_mask[w]
            ]
            if revert:
                self._engine.remove_placements(revert)  # permanent, no undo
            self._restore_victims(saved_per_pod[f])
            pod_f, reason_f, _, preev_f, retried_f = wave[f]
            # retry-finality exemption (ADVICE r5 #3): a fresh-retried head
            # whose required positive affinity selects another wave pod is
            # NOT finalized — the head verifies first in its wave, so its
            # verdict never saw that pod placed, and the serial evict/retry
            # order could still place both.  The exempted head re-queues
            # BEHIND the pods it depends on (deliberately trading the
            # victim-node re-grab protection below for the chance that the
            # anchor pod lands first); termination stays bounded by the
            # wave cap.
            affinity_dependent = id(pod_f) not in affinity_deferred and (
                _head_affinity_depends_on(
                    pod_f, [wave[w][0] for w in range(len(wave)) if w != f]
                )
            )
            if affinity_dependent and retried_f and preev_f is None:
                # this exemption actually skipped finality — consume the
                # pod's one deferral (ordering-only moves don't)
                affinity_deferred.add(id(pod_f))
            if retried_f and preev_f is None and not affinity_dependent:
                # the failed attempt was a FRESH proposal against the true
                # wave-start log state — the verify verdict is
                # serial-authoritative.  (A retried pod failing a
                # preev-carried MID-WAVE re-verify — it was demoted after
                # its fresh attempt placed — is NOT final: its victims were
                # just restored, so it re-proposes fresh next wave.)
                self._record_failed(pod_f, reason_f)
                head = []
            else:
                head = [(pod_f, reason_f, None, True)]
            # the retried head verifies FIRST: a demoted pod verifying ahead
            # of it could re-grab the head's victim node (wave evictions
            # apply before every verify), wrongly finalizing the head's
            # failure; demoted pods re-verify right after, before after-f
            # pods, keeping their relative serial order.  (Exception: an
            # affinity-dependent head queues LAST, see above.)
            rest = [
                (wave[w][0], wave[w][1], saved_per_pod[w], wave[w][4])
                for w in [*sorted(demote), *range(f + 1, len(wave))]
            ]
            pending = rest + head if affinity_dependent else head + rest

    def _restore_victims(self, records) -> None:
        """Re-insert evicted victims (a failed preemptor's) at the END of
        the placement log — append positions keep the engine log and the
        _scheduled/_placed_prio mirrors trivially parallel; log order only
        influences the most-recent-first victim tie-break, the same
        divergence class as the round-start score approximations."""
        if not records:
            return
        base = len(self._engine.placed_node)
        saved = {
            "indices": list(range(base, base + len(records))),
            "entries": [entry for entry, _, _, _ in records],
        }
        self._engine.restore_placements(saved)
        for _, vpod, vprio, vforced in records:
            self._scheduled.append(vpod)
            self._placed_prio.append(vprio)
            self._placed_forced.append(vforced)

    def _propose_victims(self, pod: dict, reason: int, model: dict):
        """Host-side victim proposal for one failed pod against the wave
        model; returns wave-start log indices of the victims (and debits
        them from the model so later proposals see the eviction), or None
        when no plausible set exists. Victim greed prefers PDB-free pods
        (lowest priority first, most recent first on ties) the way the
        reference reprieves PDB-violating victims preferentially
        (selectVictimsOnNode, default_preemption.go:639-668), and the
        violation count follows filterPodsWithPDBViolation's budget
        accounting: each matching victim decrements the PDB's
        disruptionsAllowed, violating once it goes negative. The simulation
        runs no disruption controller, so the budget is
        `status.disruptionsAllowed` as ingested (absent = 0, like the
        reference's fake cluster)."""
        from .core.objects import labels_of

        if reason not in _PREEMPTIBLE_REASONS or not len(model["prios"]):
            return None
        prio = pod_priority(pod)
        prios = np.where(model["evicted"], np.inf, model["prios"])
        placed_nodes = model["placed_nodes"]
        if not np.any(prios < prio):
            return None
        tz = self._tensorizer
        g, pin_name = _group_of_pod(pod)
        gid = tz._group_ids.get(g.signature())
        if gid is None:
            return None
        static = tz._static_mask[gid]
        alloc = tz.alloc
        r = alloc.shape[1]

        def padded(row):
            return np.pad(row, (0, r - row.shape[0])) if row.shape[0] < r else row

        placed_req = model["placed_req"]
        used = model["used"]
        pod_req = padded(self._pod_req_vector(pod))

        # per-reason victim relevance + plausibility (the retry verifies)
        pod_ports = set(tz._port_rows[gid].keys())
        anti_terms = {t for t, v in tz._a_anti[gid].items() if v}
        spread_terms = {t for t, v in tz._spread_hard[gid].items() if v > 0}
        pod_conflict_keys = set(tz._vol_rw_rows[gid]) | set(tz._vol_ro_rows[gid])
        pod_att_classes = {
            tz._vol_class[w] for w in tz._vol_att_rows[gid] if w in tz._vol_class
        }
        probe = tz.add_pods([pod])
        gpu_need = float(probe.ext["gpu_mem"][0]) * max(
            float(probe.ext["gpu_count"][0]), 1.0
        )
        lvm_need = float(np.sum(probe.ext["lvm_size"][0]))

        # PDB bookkeeping (filterPodsWithPDBViolation semantics): a PDB with
        # a nil or EMPTY selector matches nothing here — unlike the general
        # LabelSelector rule — and unlabeled pods match no PDB (upstream
        # short-circuits on `len(pod.Labels) != 0`,
        # default_preemption.go:745-746, even though a DoesNotExist selector
        # would otherwise match them; parity kept deliberately)
        pdb_list = [
            (
                namespace_of(p),
                (p.get("spec") or {}).get("selector"),
                int(((p.get("status") or {}).get("disruptionsAllowed")) or 0),
            )
            for p in self._pdbs
        ]
        _pdb_cache: dict = {}

        def pdbs_matching(i: int) -> tuple:
            got = _pdb_cache.get(i)
            if got is None:
                from .core.match import match_label_selector

                victim = self._scheduled[i]
                labels = labels_of(victim)
                got = tuple(
                    j
                    for j, (ns, sel, _) in enumerate(pdb_list)
                    if labels
                    and ns == namespace_of(victim)
                    and sel
                    and (sel.get("matchLabels") or sel.get("matchExpressions"))
                    and match_label_selector(sel, labels)
                )
                _pdb_cache[i] = got
            return got

        def pdb_violations(victim_idx) -> int:
            """How many victims push a matching PDB's budget negative."""
            allowed = [a for (_, _, a) in pdb_list]
            count = 0
            for i in victim_idx:
                violated = False
                for j in pdbs_matching(i):
                    allowed[j] -= 1
                    if allowed[j] < 0:
                        violated = True
                count += violated
            return count

        # ---- vectorized victim search -----------------------------------
        # The per-node Python loop this replaces cost O(nodes × placed) per
        # failed pod — unusable against 10^5-node clusters with 10^6-entry
        # placement logs (VERDICT r2 task 5). Everything below is whole-log
        # numpy: candidate relevance by reason, the PDB reprieve split, the
        # greedy per-node eviction prefix, and the pickOneNode key all
        # evaluate per placement-log ENTRY over sorted node segments.
        n_nodes = len(self._nodes)
        placed_groups_a = model["placed_groups"]
        g_count = len(tz.groups)

        # victim relevance per reason, at group granularity where possible
        if reason == FAIL_PORTS:
            rel_g = np.array(
                [bool(pod_ports & set(tz._port_rows[vg].keys())) for vg in range(g_count)]
            )
            relevant = rel_g[placed_groups_a]
        elif reason == FAIL_INTERPOD:
            rel_g = np.array(
                [any(tz._s_match[vg].get(t) for t in anti_terms) for vg in range(g_count)]
            )
            relevant = rel_g[placed_groups_a]
        elif reason == FAIL_SPREAD:
            rel_g = np.array(
                [any(tz._s_match[vg].get(t) for t in spread_terms) for vg in range(g_count)]
            )
            relevant = rel_g[placed_groups_a]
        elif reason == FAIL_VOLUME:
            # the victim must hold one of the conflicting volume identities
            # via a rw/ro mount — attach-only usage (resolved PVC
            # attachables) cannot cause a VolumeRestrictions conflict
            rel_g = np.array(
                [
                    bool(
                        pod_conflict_keys
                        & (set(tz._vol_rw_rows[vg]) | set(tz._vol_ro_rows[vg]))
                    )
                    for vg in range(g_count)
                ]
            )
            relevant = rel_g[placed_groups_a]
        elif reason == FAIL_ATTACH:
            # evicting any holder of a same-class attachable frees a slot
            rel_g = np.array(
                [
                    bool(
                        pod_att_classes
                        & {
                            tz._vol_class[w]
                            for w in set(tz._vol_att_rows[vg]) | set(tz._vol_rw_rows[vg])
                            if w in tz._vol_class
                        }
                    )
                    for vg in range(g_count)
                ]
            )
            relevant = rel_g[placed_groups_a]
        elif reason == FAIL_GPU:
            relevant = model["gpu_mem_log"] > 0
        elif reason == FAIL_STORAGE:
            relevant = (model["vg_use_log"] > 0) | model["sd_any_log"]
        else:  # FAIL_RESOURCES: any eviction frees resources
            relevant = np.ones(len(placed_groups_a), bool)

        node_ok = np.asarray(static, bool).copy()
        if getattr(self._engine, "node_valid", None) is not None:
            # fault-masked nodes (simtpu/faults/drain.py) are not landing
            # sites: the engine's filter pipeline is guaranteed to reject
            # them at verify, so proposing one only burns a wave
            node_ok &= np.asarray(self._engine.node_valid, bool)
        if pin_name is not None:
            # the pin restricts WITHIN the static mask (the serial loop
            # checked static first): a pinned node the pod can never place
            # on must not trigger a doomed evict/retry/restore round-trip
            pin_idx = tz.node_idx.get(pin_name, -1)
            keep = node_ok[pin_idx] if pin_idx >= 0 else False
            node_ok[:] = False
            if keep:
                node_ok[pin_idx] = True
        cand_mask = (prios < prio) & relevant & node_ok[placed_nodes]
        cand = np.flatnonzero(cand_mask)
        if not len(cand):
            return None
        c_nodes = placed_nodes[cand]
        c_prios = prios[cand]

        # PDB reprieve split (filterPodsWithPDBViolation): walk each node's
        # candidates in MoreImportantPod order (priority desc, index asc)
        # decrementing budgets; a victim is VIOLATING once a matching PDB's
        # budget goes negative. Vectorized as per-(pdb, node) running counts
        # along the sorted order.
        j_pdbs = len(pdb_list)
        violating1 = np.zeros(len(cand), bool)
        pdb_match_c = None
        if j_pdbs:
            pdb_match_c = np.zeros((j_pdbs, len(cand)), bool)
            for ci, i in enumerate(cand):
                for j in pdbs_matching(int(i)):
                    pdb_match_c[j, ci] = True
            order1 = np.lexsort((cand, -c_prios, c_nodes))
            n_sorted1 = c_nodes[order1]
            seg_start1 = np.concatenate(
                [[True], n_sorted1[1:] != n_sorted1[:-1]]
            )
            seg_id1 = np.cumsum(seg_start1) - 1
            first_pos = np.flatnonzero(seg_start1)
            for j in range(j_pdbs):
                mj = pdb_match_c[j][order1].astype(np.int64)
                cum = np.cumsum(mj)
                base = (cum - mj)[first_pos]  # exclusive cum at segment start
                rank = cum - base[seg_id1]  # inclusive count within segment
                violating1[order1] |= (mj > 0) & (rank > pdb_list[j][2])

        # greedy eviction order per node: non-violating first, lowest
        # priority first, later placements first on ties
        order2 = np.lexsort((-cand, c_prios, violating1, c_nodes))
        n2 = c_nodes[order2]
        seg_start2 = np.concatenate([[True], n2[1:] != n2[:-1]])
        seg_id2 = np.cumsum(seg_start2) - 1
        n_segs = int(seg_id2[-1]) + 1
        seg_first = np.flatnonzero(seg_start2)
        seg_node = n2[seg_first]

        def seg_cumsum(vals):
            """Within-segment inclusive cumulative sum along order2."""
            cum = np.cumsum(vals, axis=0)
            base = (cum - vals)[seg_first]
            return cum - base[seg_id2]

        req2 = placed_req[cand][order2]  # [C, R]
        cum_req = seg_cumsum(req2)
        free0 = (alloc - used)[seg_node[seg_id2]]  # [C, R] start free per row
        res_ok = np.all(
            free0 + cum_req >= pod_req[None, :] - 1e-6, axis=1
        )
        if reason == FAIL_GPU:
            gpu_free0 = tz.ext.gpu_dev_total.sum(axis=1) - model["gpu_used_n"]
            cum_gpu = seg_cumsum(model["gpu_use_log"][cand][order2])
            res_ok &= (
                gpu_free0[seg_node[seg_id2]] + cum_gpu >= gpu_need - 1e-6
            )
        elif reason == FAIL_STORAGE:
            vg_free0 = (
                tz.ext.vg_cap.sum(axis=1) - tz.ext.vg_req0.sum(axis=1)
            ) - model["vg_used_n"]
            cum_vg = seg_cumsum(model["vg_use_log"][cand][order2])
            res_ok &= vg_free0[seg_node[seg_id2]] + cum_vg >= lvm_need - 1e-6
        elif reason in (FAIL_PORTS, FAIL_INTERPOD, FAIL_SPREAD, FAIL_VOLUME, FAIL_ATTACH):
            # every relevant victim on the node must go (a single eviction
            # may leave another conflicting holder or a saturated class)
            is_last = np.concatenate([seg_start2[1:], [True]])
            res_ok &= is_last

        # minimal qualifying prefix per segment
        pos_in_seg = np.arange(len(order2)) - seg_first[seg_id2]
        first_ok = np.full(n_segs, np.iinfo(np.int64).max)
        ok_pos = np.flatnonzero(res_ok)
        np.minimum.at(first_ok, seg_id2[ok_pos], pos_in_seg[ok_pos])
        valid_seg = first_ok < np.iinfo(np.int64).max
        if not valid_seg.any():
            return None

        # pickOneNode key on each segment's prefix: (PDB violations counted
        # in eviction order, highest victim priority, summed priorities,
        # victim count, node index)
        prio2 = c_prios[order2].astype(np.float64)
        cum_prio = seg_cumsum(prio2)
        # segmented running max via monotone per-segment offsets: shift
        # priorities to [0, range] and add seg_id*(range+1) — offsets stay
        # far below 2^53, so the subtraction is exact
        p_min = float(prio2.min())
        span = float(prio2.max()) - p_min + 1.0
        off = seg_id2.astype(np.float64) * span
        cum_max = np.maximum.accumulate(prio2 - p_min + off) - off + p_min
        if j_pdbs:
            viol2 = np.zeros(len(order2), bool)
            for j in range(j_pdbs):
                mj = pdb_match_c[j][order2].astype(np.int64)
                rank = seg_cumsum(mj)
                viol2 |= (mj > 0) & (rank > pdb_list[j][2])
            cum_viol = seg_cumsum(viol2.astype(np.int64))
        else:
            cum_viol = np.zeros(len(order2), np.int64)
        sel = seg_first + np.where(valid_seg, first_ok, 0)
        keys = np.lexsort(
            (
                seg_node,
                first_ok + 1,
                cum_prio[sel],
                cum_max[sel],
                cum_viol[sel],
                ~valid_seg,  # invalid segments last
            )
        )
        best_seg = int(keys[0])
        if not valid_seg[best_seg]:
            return None
        node = int(seg_node[best_seg])
        a = int(seg_first[best_seg])
        b = a + int(first_ok[best_seg]) + 1
        victims = [int(cand[i]) for i in order2[a:b]]

        # debit the model so later proposals in this wave see the eviction
        # AND the preemptor's own predicted landing on the freed node —
        # without the latter, every later proposal chases the phantom free
        # space of the first eviction (a 1-victim set on an already-freed
        # node wins the fewest-victims key) and the whole wave fails
        # verification. The prediction can be wrong (the batched verify
        # places wherever the real pipeline says); the verify corrects it.
        model["evicted"][victims] = True
        model["prios"][victims] = np.inf
        model["used"][node] -= placed_req[victims].sum(axis=0)
        model["used"][node] += pod_req
        model["gpu_used_n"][node] -= model["gpu_use_log"][victims].sum()
        model["gpu_used_n"][node] += gpu_need
        model["vg_used_n"][node] -= model["vg_use_log"][victims].sum()
        model["vg_used_n"][node] += lvm_need
        return victims

    def _pod_req_vector(self, pod: dict):
        """The pod's request row in the tensorizer's resource vocabulary."""
        from .core.objects import pod_requests
        from .core.tensorize import RES_PODS

        req = np.zeros(len(self._tensorizer.resources), np.float32)
        req[RES_PODS] = 1.0
        for rname, val in pod_requests(pod).items():
            ridx = self._tensorizer.resources.get(rname)
            if ridx >= 0:
                req[ridx] = val
        return req

    def _result(self) -> SimulateResult:
        by_node = {name_of(n): [] for n in self._nodes}
        for pod in self._scheduled:
            by_node[pod["spec"]["nodeName"]].append(shallow_pod_copy(pod))
        nodes = [deep_copy(n) for n in self._nodes]
        write_extended_annotations(self._tensorizer.ext, self._engine.ext_log, nodes)
        statuses = [NodeStatus(node=n, pods=by_node[name_of(n)]) for n in nodes]
        return SimulateResult(
            unscheduled_pods=list(self._unscheduled),
            node_status=statuses,
            preempted_pods=list(self._preempted),
        )


    # -- decision observability (explain/) ---------------------------------

    def explain_result(self, opts: Optional[dict] = None) -> dict:
        """The versioned explain block for this simulation's unscheduled
        pods: the per-stage failure breakdown (against the end-of-run
        carried state, through K20 on the card) plus the binding-constraint
        bottleneck analysis.

        `opts` keys (all optional): `top` — failure-shape groups kept
        (default 10); `new_node`/`daemon_sets`/`corrected` — the capacity
        planners' template context, folded into the bottleneck's
        can-another-node-ever-help verdict. Pure read: re-adding the
        already-interned unscheduled pods grows no vocabulary and the
        carried state is only read (`Engine.carried_state`, a compact carry
        expanded through K12 into fresh planes)."""
        from .explain import build_explain_doc

        opts = opts or {}
        if not self._unscheduled or self._engine is None:
            # nothing to explain: a FALSY doc, so callers' `if explain:`
            # guards skip it
            return {}
        pods = [u.pod for u in self._unscheduled]
        codes = np.asarray(self._unscheduled_codes, np.int32)
        batch = self._tensorizer.add_pods(pods)
        tensors = self._tensorizer.freeze()
        node_valid = (
            np.asarray(self._engine.node_valid, bool)
            if self._engine.node_valid is not None
            else None
        )
        try:
            state = self._engine.carried_state()
        except ValueError:
            # a preemption fallback left the carry dirty (rebuilt on the
            # next place) — the placement log is still authoritative
            state = None
        if state is None:
            from .engine.state import build_state

            r = tensors.alloc.shape[1]
            state = build_state(
                tensors,
                np.asarray(self._engine.placed_group, np.int32),
                np.asarray(self._engine.placed_node, np.int32),
                self._engine.log_req_matrix(r),
                self._engine.ext_log,
                self._device,
            )
        return build_explain_doc(
            tensors, batch, np.arange(len(pods)), state,
            np.full(len(pods), -1, np.int64), codes,
            node_valid=node_valid, sched_config=self._sched_config,
            new_node=opts.get("new_node"),
            daemon_sets=opts.get("daemon_sets") or (),
            corrected_ds_overhead=bool(opts.get("corrected", False)),
            top=int(opts.get("top", 10)),
        )


def record_placed_pod(pod: dict, node_name: str, gpu_shares) -> dict:
    """The placed copy of `pod`: nodeName bound, phase Running, and the GPU
    device-assignment annotation the reference's GpuSharePlugin.Bind
    applies."""
    placed = shallow_pod_copy(pod)
    placed["spec"]["nodeName"] = node_name
    placed.setdefault("status", {})["phase"] = "Running"
    already = annotations_of(placed).get(C.ANNO_POD_GPU_INDEX)
    if gpu_shares.sum() > 0 and not already:
        ids = []
        for dev_id, cnt in enumerate(gpu_shares):
            ids.extend([str(dev_id)] * int(round(float(cnt))))
        set_annotation(placed, C.ANNO_POD_GPU_INDEX, "-".join(ids))
    return placed


def write_extended_annotations(ext, log: dict, nodes: List[dict]) -> None:
    """Mirror the storage/GPU state the reference's Bind/Reserve plugins
    write back into node annotations. `ext` is the tensorizer's
    ExtendedNodeArrays, `log` an engine ext_log (node-parallel lists)."""
    import json as _json

    from .core.extended import NodeStorage

    n = len(nodes)
    v = ext.vg_cap.shape[1]
    sd = ext.sdev_cap.shape[1]
    gd = ext.gpu_dev_total.shape[1]
    vg_used = np.zeros((n, v), np.float64)
    sdev_taken = np.zeros((n, sd), bool)
    gpu_used = np.zeros((n, gd), np.float64)
    gpu_pods = np.zeros(n, np.int64)
    for node_idx, vg_alloc, take, shares, mem in zip(
        log["node"], log["vg_alloc"], log["sdev_take"], log["gpu_shares"], log["gpu_mem"]
    ):
        vg_used[node_idx] += vg_alloc
        sdev_taken[node_idx] |= take
        gpu_used[node_idx] += np.asarray(shares) * mem
        if mem > 0:
            gpu_pods[node_idx] += 1
    for i, node in enumerate(nodes):
        storage = NodeStorage.from_node(node)
        if storage is not None:
            for j, vg in enumerate(storage.vgs):
                if j < v:
                    prev = parse_quantity(vg.get("requested") or 0)
                    vg["requested"] = int(prev + vg_used[i, j])
                    if isinstance(vg.get("capacity"), str):
                        vg["capacity"] = int(parse_quantity(vg["capacity"]))
            for j, dev in enumerate(storage.devices):
                if j < sd and sdev_taken[i, j]:
                    dev["isAllocated"] = True
            set_annotation(
                node,
                C.ANNO_NODE_LOCAL_STORAGE,
                _json.dumps({"vgs": storage.vgs, "devices": storage.devices}),
            )
        if ext.gpu_total[i] > 0:
            devs = {
                str(j): {
                    "gpuTotalMemory": int(ext.gpu_dev_total[i, j]),
                    "gpuUsedMemory": int(gpu_used[i, j]),
                }
                for j in range(gd)
                if ext.gpu_dev_total[i, j] > 0
            }
            info = {
                "gpuCount": int((ext.gpu_dev_total[i] > 0).sum()),
                "gpuAllocatable": int(((ext.gpu_dev_total[i] > 0) & (gpu_used[i] == 0)).sum()),
                "gpuTotalMemory": int(ext.gpu_total[i]),
                "gpuUsedMemory": int(gpu_used[i].sum()),
                "numPods": int(gpu_pods[i]),
                "devs": devs,
            }
            set_annotation(node, C.ANNO_NODE_GPU_SHARE, _json.dumps(info))


def simulate(
    cluster: ResourceTypes,
    apps: Sequence[AppResource] = (),
    extended_resources: Sequence[str] = (),
    engine_factory=None,
    use_greed: bool = False,
    sched_config=None,
    device=None,
    audit: bool = False,
    _audit_inject: bool = False,
    bulk: bool = False,
    explain=False,
) -> SimulateResult:
    """One-shot simulation: expand cluster workloads, run the cluster, then
    schedule each app in order. Unscheduled pods accumulate across the
    cluster and every app; node status reflects the final cluster.

    `device=None` runs on the CUDA card (RuntimeError without one);
    `device="cpu"` runs the plain PyTorch path. `engine_factory(tensorizer,
    device)` builds the engine (None = `Engine`, the speculative wavefront
    on), e.g. one with `speculate = False`.

    With `audit=True` the independent placement auditor (`audit/checker.py`)
    certifies the final state — engine placement log, preemption legality —
    on the same device and attaches its `AuditReport` as `result.audit`
    before the simulator closes. `_audit_inject` corrupts the audit's VIEW
    (never the result), so the planner's divergence fallback can be driven
    end to end.

    `bulk=True` places eligible same-spec pod runs in bulk rounds
    (`engine/rounds.py RoundsEngine`, the JAX package's bulk tie-breaks);
    it excludes `engine_factory`.

    With `explain=True` (or an options dict — `{"top", "new_node",
    "daemon_sets", "corrected"}`) the decision-observability block
    (`explain/`: per-stage failure breakdowns against the end-of-run state,
    K20 on the card, and the binding-constraint bottleneck analysis) is
    attached as `result.explain` before the simulator closes. Off (the
    default) imports no explain module and launches nothing more."""
    if bulk:
        if engine_factory is not None:
            raise ValueError("bulk=True and engine_factory are mutually exclusive")
        from .engine.rounds import RoundsEngine

        engine_factory = RoundsEngine
    sim = Simulator(
        extra_resources=extended_resources,
        use_greed=use_greed,
        sched_config=sched_config,
        device=device,
        engine_factory=engine_factory,
    )
    cluster = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
    try:
        cluster_pods = get_valid_pods_exclude_daemonset(cluster)
        for ds in cluster.daemon_sets:
            cluster_pods.extend(make_valid_pods_by_daemonset(ds, cluster.nodes))
        cluster.pods = cluster_pods
        result = sim.run_cluster(cluster)
        for app in apps:
            result = sim.schedule_app(app)
        if audit:
            from .audit.checker import audit_simulation

            result.audit = audit_simulation(sim, inject=_audit_inject)
        if explain:
            result.explain = sim.explain_result(explain if isinstance(explain, dict) else None)
        return result
    finally:
        sim.close()
