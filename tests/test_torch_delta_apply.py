"""K7 `delta_apply` on the dense carry: its plain version against the JAX
package, its design emulated on the CPU, its launch plan, its weight flag
and its wrapper.

1. `apply_placement_deltas_plain` against the JAX package's
   `apply_placement_deltas` on dense carries: a zone-keyed one (the mixed
   problem of tests/test_torch_compact.py, the compact carry off) and a
   hostname-only one (no tabular row), batches with the same node many
   times, w = 0 padding and node = -1, and statics whose preference
   weights are not integers (2.5, 0.3, ...); evicted, then restored. Bit
   for bit after each step; the integer cases' round trip gives back the
   state before it.
2. The kernel's design in numpy (`_emulate_k7`): the pair adds at every
   node of the chosen node's domain in a shuffled order, the entries
   grouped into node runs in log order and each element walked through its
   run, the preference planes in a shuffled order where `cuda.pref_mode`
   allows it and in log order where it does not: equal to the plain
   version bit for bit on the same cases.
3. `cuda.compact_delta_plan` with K7's pair threads and preference
   blocks: every (pair, node of its domain), (element, run) walker and
   preference thread or row on exactly one thread, each pair thread's
   pair between its chunk's hints (`cuda.pair_hints`); `cuda.pair_starts`
   sizing each pair by its own domain; `cuda.pref_mode` on the statics
   that set and clear it; the per-statics setup shared by statics that
   differ only in fields K7 does not read, bounded, and K18's block built
   from it.
4. The wrapper: its plan, the domains' node lists and one upload with the
   pair starts and the zeroed pref_seen word (a recording stand-in for the
   library), and the weights it refuses.

All inputs come from numpy seeds; nothing here needs a card.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda

from .test_torch_compact import _assert_equal, _entries_of, _mod, _pack, _place, _preempt_problem
from .test_torch_filter_storage import _FakeLib
from ._threads import one_torch_thread  # noqa: F401 (autouse)

F32 = np.float32
#: the fractional preference weights (0 where a slot has no ip row)
FRACTIONAL = (2.5, 0.3, 1.75, 0.6)


def _hostname_engine(pkg):
    """72 nodes whose only topology key is the hostname (no tabular count
    row: the carry is dense), preferred and required anti-affinity and a
    spread on it, placed in one batch."""
    synth = _mod(pkg, "synth")
    host = "kubernetes.io/hostname"
    cluster, _ = _preempt_problem(pkg)
    cluster.nodes = [synth.make_node(f"node-{i:06d}", 8000, 32, {host: f"node-{i:06d}"}) for i in range(72)]
    deps = [synth.make_deployment("web", 90, 500, 256, anti_affinity_topo=host),
            synth.make_deployment("db", 40, 1000, 512, anti_affinity_topo=host, anti_affinity_required=True),
            synth.make_deployment("api", 60, 300, 128, spread_topo=host)]
    pods = _mod(pkg, "workloads.expand").get_valid_pods_exclude_daemonset(pkg.ResourceTypes(deployments=deps))
    tz = _mod(pkg, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    eng = jscan.Engine(tz) if pkg is simtpu else tscan.Engine(tz, "cpu")
    eng.compact = False
    eng.place(tz.add_pods(pods))
    return eng


@pytest.fixture(scope="module")
def dense():
    """The JAX package's and the port's engines on the mixed problem (the
    compact carry off) and on the hostname problem: (JAX engine, port
    engine) each."""
    out = {"zone": tuple(_place(pkg, "mixed", compact=False, batches=1)[0] for pkg in (simtpu, simtpu_torch))}
    out["hostname"] = tuple(_hostname_engine(pkg) for pkg in (simtpu, simtpu_torch))
    return out


def _weights(statics, rng, values):
    """Both preference weight planes drawn from `values` on every slot whose
    term has an ip row, as numpy."""
    terms = statics.g_terms.numpy()
    ip = statics.ip_of.numpy()
    has = (terms >= 0) & (ip[np.maximum(terms, 0)] >= 0)
    return [np.where(has, rng.choice(np.asarray(values, F32), terms.shape), F32(0)).astype(F32) for _ in range(2)]


def _case(dense, name, e, seed, weights=None):
    """(JAX statics, JAX state, port statics, port state, the packed
    eviction and restore of each package) for `e` entries drawn with
    repeats from the placed log, one of them moved to node -1 and the
    batch padded to a power of two; `weights` the preference values to
    draw, where given, into both packages' statics."""
    j_eng, t_eng = dense[name]
    j_tensors, t_tensors = j_eng.tensorizer.freeze(), t_eng.tensorizer.freeze()
    j_statics = jscan.statics_from(j_tensors, None)
    t_statics = tscan.statics_from(t_tensors, None, "cpu")
    rng = np.random.default_rng(seed)
    if weights is not None:
        wa, wn = _weights(t_statics, rng, weights)
        j_statics = j_statics._replace(w_aff_pref=jnp.asarray(wa), w_anti_pref=jnp.asarray(wn))
        t_statics = t_statics._replace(w_aff_pref=torch.from_numpy(wa), w_anti_pref=torch.from_numpy(wn))
    t_state = t_eng.carried_state()
    t_state = type(t_state)(*(x.clone() for x in t_state))  # the engine's carry stays as placed
    idx = rng.choice(len(t_eng.placed_node), e, replace=True).tolist()
    packed = {}
    for pkg, eng, tensors in ((simtpu, j_eng, j_tensors), (simtpu_torch, t_eng, t_tensors)):
        for sign in (-1.0, 1.0):
            p = [np.array(a) for a in _pack(pkg, tensors, _entries_of(eng, idx), sign)]
            p[1][e // 2] = -1  # node -1 reads node 0
            packed[pkg.__name__, sign] = tuple(p)
    return j_statics, j_eng.carried_state(), t_statics, t_state, packed


def _np_state(state):
    return {f: np.array(x, copy=True) for f, x in zip(state._fields, state)}


def _jax_apply(statics, state, packed):
    return jstate.apply_placement_deltas(statics, jax.tree_util.tree_map(jnp.copy, state),
                                         tuple(map(jnp.asarray, packed)))


# -- 1. the plain version against the JAX package ------------------------------


@pytest.mark.parametrize("name, e, weights", [("zone", 200, None), ("zone", 1000, None), ("hostname", 200, None),
                                              ("zone", 200, FRACTIONAL), ("hostname", 300, FRACTIONAL),
                                              ("zone", 300, tuple(range(1, 101)))],
                         ids=["zone-200", "zone-1000", "hostname-200", "zone-fractional", "hostname-fractional",
                              "zone-integer-weights"])
def test_plain_k7_equals_the_jax_delta(dense, name, e, weights):
    j_statics, j_state, t_statics, t_state, packed = _case(dense, name, e, e, weights)
    before = _np_state(t_state)
    nodes = packed["simtpu_torch", -1.0][1][:e]
    assert len(np.unique(nodes)) < e and (packed["simtpu_torch", -1.0][2] == 0).any()  # repeats, padding
    if name == "hostname":
        assert not tstate.compact_spec(dense[name][1].tensorizer.freeze()).enabled
    for sign in (-1.0, 1.0):
        j_state = _jax_apply(j_statics, j_state, packed["simtpu", sign])
        tstate.apply_placement_deltas_plain(t_statics, t_state, packed["simtpu_torch", sign])
        _assert_equal(t_state, j_state, f"{name}, E={e}, w = {sign:+.0f}")
        if sign < 0:
            moved = [f for f, a in _np_state(t_state).items() if not np.array_equal(a, before[f])]
            assert {"free", "cnt_match", "cnt_total"} <= set(moved), moved
            if weights is not None:
                assert {"w_own_aff_pref", "w_own_anti_pref"} <= set(moved), moved
    if weights is None or weights == tuple(range(1, 101)):
        # integer planes back bit for bit (free holds fractional cores)
        after = _np_state(t_state)
        for f in tstate.SchedState._fields:
            if f != "free":
                assert np.array_equal(after[f], before[f]), f


# -- 2. the kernel's design in numpy -----------------------------------------


def _emulate_k7(statics, state, packed, rng):
    """K7's two kernels in numpy f32 on copies of `state`: (1) the pair
    threads of `cuda.pair_starts` in a shuffled order, each finding its
    (entry, slot) pair and its node of the chosen node's domain
    (cuda.domain_nodes) as the kernel does, adding the counts there (the
    pair's first thread cnt_total) and keeping the largest touched
    |preference value|; (2) the live entries grouped into runs by node in
    log order and each element of a run's node walked through the run
    (delta_rows.cuh's operands), then the preference planes: the pair
    threads in a shuffled order where pref_mode and the touched values
    allow it, else each cell's pairs in log order."""
    s = {f: np.array(x.numpy()) for f, x in zip(state._fields, state)}
    st = {f: x.numpy() for f, x in zip(statics._fields, statics)}
    g, node, w, req, vg, sd, gp = (np.asarray(a) for a in packed)
    e_n, tc = len(g), st["g_terms"].shape[1]
    start, nodes = (t.numpy() for t in cuda.domain_nodes(statics.node_dom))
    threads = cuda.pair_starts(cuda._delta_setup(statics, state), g, node, w)
    hint = cuda.pair_hints(threads)
    mode = cuda.pref_mode(statics, e_n)

    def chain(e, t):
        if w[e] == 0:
            return None
        c = max(int(node[e]), 0)
        term = st["g_terms"][g[e], t]
        if term < 0:
            return None
        dom = st["node_dom"][st["term_topo"][term], c]
        return None if dom < 0 else (term, int(st["ip_of"][term]), int(dom))

    def thread(j):
        # pair thread j: its pair (the last start at or below j, searched
        # between its chunk's hints), its node (the k-th of the domain) and
        # whether it is the pair's first
        lo, hi = hint[j // cuda.DELTA_PAIR_CHUNK], hint[j // cuda.DELTA_PAIR_CHUNK + 1] + 1
        pair = lo + int(np.searchsorted(threads[lo:hi], j, side="right")) - 1
        assert threads[lo] <= j < threads[hi]
        e, t = divmod(pair, tc)
        got = chain(e, t)
        assert got is not None, "a pair of no node has no thread"
        k = j - threads[pair]
        assert start[got[2]] + k < start[got[2] + 1], "a thread past its pair's domain"
        return e, t, got, int(nodes[start[got[2]] + k]), k == 0

    work = int(threads[-1])
    most = F32(0)
    for j in rng.permutation(work):
        e, t, (term, ip, dom), m, first = thread(j)
        one = F32(w[e])
        sv = F32(1.0 if st["s_match"][g[e], t] else 0.0) * one
        if first:
            s["cnt_total"][term] += sv
        s["cnt_match"][term, m] += sv
        if ip >= 0:
            s["cnt_own_anti"][ip, m] += F32(1.0 if st["a_anti_req"][g[e], t] else 0.0) * one
            s["cnt_own_aff"][ip, m] += F32(1.0 if st["a_aff_req"][g[e], t] else 0.0) * one
            if mode >= 0 and (st["w_aff_pref"][g[e], t] != 0 or st["w_anti_pref"][g[e], t] != 0):
                for v in (s["w_own_aff_pref"][ip, m], s["w_own_anti_pref"][ip, m]):
                    most = max(most, abs(v) if v == np.trunc(v) else F32(np.inf))
    # the runs: each node's live entries in log order
    runs = {}
    for e in range(e_n):
        if w[e] != 0:
            runs.setdefault(max(int(node[e]), 0), []).append(e)
    for c, run in runs.items():
        for e in run:
            one = F32(w[e])
            s["free"][c] = s["free"][c] + (-req[e]) * one
            s["ports_used"][c] = s["ports_used"][c] + st["ports_req"][g[e]].astype(F32) * one
            rw = st["vol_rw_req"][g[e]]
            present = rw | st["vol_ro_req"][g[e]] | st["vol_att_req"][g[e]]
            s["vols_any"][c] = s["vols_any"][c] + present.astype(F32) * one
            s["vols_rw"][c] = s["vols_rw"][c] + rw.astype(F32) * one
            s["vg_free"][c] = s["vg_free"][c] + (-vg[e]) * one
            s["sdev_free"][c] = s["sdev_free"][c] & ~sd[e] if one > 0 else s["sdev_free"][c] | sd[e]
            s["gpu_free"][c] = s["gpu_free"][c] + (-gp[e]) * one
    if mode > 0 and most < F32(mode):
        # the atomic path: the pair threads in any order
        for j in rng.permutation(work):
            e, t, (_, ip, _), m, _ = thread(j)
            if ip >= 0:
                s["w_own_aff_pref"][ip, m] += st["w_aff_pref"][g[e], t] * F32(w[e])
                s["w_own_anti_pref"][ip, m] += st["w_anti_pref"][g[e], t] * F32(w[e])
    elif mode >= 0:
        # the log order: each cell's pairs in entry order
        for e in range(e_n):
            for t in range(tc):
                got = chain(e, t)
                if got is None or got[1] < 0:
                    continue
                _, ip, dom = got
                for m in nodes[start[dom]:start[dom + 1]]:
                    s["w_own_aff_pref"][ip, m] += st["w_aff_pref"][g[e], t] * F32(w[e])
                    s["w_own_anti_pref"][ip, m] += st["w_anti_pref"][g[e], t] * F32(w[e])
    return tstate.SchedState(**{f: torch.from_numpy(v) for f, v in s.items()}), mode, most


@pytest.mark.parametrize("name, e, weights", [("zone", 200, None), ("hostname", 200, None),
                                              ("zone", 200, FRACTIONAL), ("zone", 300, tuple(range(1, 101))),
                                              ("hostname", 200, tuple(range(1, 101)))],
                         ids=["zone", "hostname", "zone-fractional", "zone-integer-weights",
                              "hostname-integer-weights"])
def test_the_kernels_design_equals_the_plain_version(dense, name, e, weights):
    _, _, t_statics, plain, packed = _case(dense, name, e, 7 + e, weights)
    rng = np.random.default_rng(e)
    for sign in (-1.0, 1.0):
        got, mode, most = _emulate_k7(t_statics, plain, packed["simtpu_torch", sign], rng)
        tstate.apply_placement_deltas_plain(t_statics, plain, packed["simtpu_torch", sign])
        _assert_equal(got, plain, f"{name}, E={e}, w = {sign:+.0f}")
        # the preference path each case takes (the problems' own weights
        # are integers: the hostname problem's preferred anti-affinity)
        weighted = bool((t_statics.w_aff_pref != 0).any() or (t_statics.w_anti_pref != 0).any())
        assert (mode == -1) == (not weighted) and (weights is None or weighted)
        assert (mode == 0) == (weights == FRACTIONAL)
        if mode > 0:
            assert most < mode  # the atomic path


def test_the_design_takes_the_log_order_past_the_bound(dense):
    """Integer weights, but preference values past the bound: the emulated
    kernel takes the log order (the shuffled order would round them
    differently) and equals the plain version."""
    _, _, t_statics, t_state, packed = _case(dense, "zone", 300, 9, tuple(range(1, 101)))
    rng = np.random.default_rng(9)
    big = F32(cuda.F32_EXACT - 3)
    t_state = t_state._replace(w_own_aff_pref=torch.full_like(t_state.w_own_aff_pref, big),
                               w_own_anti_pref=torch.full_like(t_state.w_own_anti_pref, -big))
    got, mode, most = _emulate_k7(t_statics, t_state, packed["simtpu_torch", -1.0], rng)
    assert 0 < mode <= most
    tstate.apply_placement_deltas_plain(t_statics, t_state, packed["simtpu_torch", -1.0])
    _assert_equal(got, t_state, "past the bound")


# -- 3. the launch plan and the weight flag ------------------------------------


@pytest.mark.parametrize("n, e, tc, width, most, ti", [(1, 1, 1, 5, 1, 1), (72, 256, 4, 20, 24, 3),
                                                       (1000, 200, 4, 27, 63, 40), (1000, 2048, 8, 27, 1, 0),
                                                       (5000, 256, 512, 9, 3, 300), (100000, 4096, 2, 3, 7, 5000),
                                                       (100000, 64, 4, 3, 100000, 2)])
def test_k7_plan_covers_every_pair_walker_and_preference_pair_once(n, e, tc, width, most, ti):
    # pairs of 0 to `most` nodes each (padding and empty slots take none)
    rng = np.random.default_rng(n + e)
    sizes = np.where(rng.random(e * tc) < 0.2, 0, rng.integers(1, most + 1, e * tc))
    start = np.zeros(e * tc + 1, np.int64)
    np.cumsum(sizes, out=start[1:])
    work = int(start[-1])
    for threads in (None, 128, 1024):
        plan = cuda.compact_delta_plan(n, e, tc, width, threads, work=work, pref_rows=ti)
        t, walkers = plan["threads"], e * width
        for blocks, per, total in ((plan["pair_blocks"], t, work), (plan["walk_blocks"], cuda.DELTA_WALK_THREADS,
                                                                     walkers)):
            assert (blocks - 1) * per < total <= blocks * per
        # the pair threads' map (delta_apply.cu delta_slot): the last start
        # at or below j, and j's place in that pair: each (pair, k-th node)
        # once, every node of every pair, no pair of no node
        j = np.arange(0, work, max(work // 50_000, 1))
        pair = np.searchsorted(start, j, side="right") - 1
        k = j - start[pair]
        assert (sizes[pair] > 0).all() and (k < sizes[pair]).all() and (k >= 0).all()
        # the hints bracket each thread's pair: start[lo] <= j < start[hi]
        hint = cuda.pair_hints(start)
        assert len(hint) == -(-work // cuda.DELTA_PAIR_CHUNK) + 1 and hint[-1] == e * tc - 1
        lo, hi = hint[j // cuda.DELTA_PAIR_CHUNK], hint[j // cuda.DELTA_PAIR_CHUNK + 1] + 1
        assert (lo <= pair).all() and (pair < hi).all() and (start[lo] <= j).all() and (j < start[hi]).all()
        if len(j) == work:
            assert len(set(zip(pair.tolist(), k.tolist()))) == work and (np.bincount(pair, minlength=e * tc) == sizes).all()
        # the (element, run) walkers: divmod(j, E) once each
        w = np.arange(walkers)
        assert len(set(zip(*(x.tolist() for x in np.divmod(w, e))))) == walkers
        # the preference blocks: as many as either path can use, at most
        # DELTA_PREF_BLOCKS; the atomic path's grid-stride loop and the
        # log order's row loop each cover their work once
        pb = plan["pref_blocks"]
        assert pb == min(max(-(-work // cuda.DELTA_WALK_THREADS), ti), cuda.DELTA_PREF_BLOCKS) > 0
        step = pb * cuda.DELTA_WALK_THREADS
        assert -(-work // step) * step >= work and sorted(i % pb for i in range(ti)) == sorted(
            b for b in range(pb) for _ in range(b, ti, pb))
        assert cuda.compact_delta_plan(n, e, tc, width, threads, work=work)["pref_blocks"] == 0
    # no pair threads: no preference blocks, no pair blocks
    none = cuda.compact_delta_plan(n, e, tc, width, work=0, pref_rows=ti)
    assert none["pref_blocks"] == 0 and none["pair_blocks"] == 0


def test_pair_starts_size_each_pair_by_its_own_domain(dense):
    """`cuda.pair_starts` gives each (entry, slot) pair the nodes of the
    chosen node's domain under the slot's own key (node -1 reads node 0),
    and none to padding, an empty slot or a node without the key; on a
    one-domain layout every live pair takes all N nodes."""
    _, _, t_statics, t_state, packed = _case(dense, "zone", 200, 11, None)
    g, node, w = (np.asarray(a) for a in packed["simtpu_torch", -1.0][:3])
    st = {f: x.numpy() for f, x in zip(t_statics._fields, t_statics)}
    n, tc = t_state.free.shape[0], st["g_terms"].shape[1]

    def direct(statics):
        nd = statics.node_dom.numpy()
        sizes = np.bincount(nd[nd >= 0], minlength=int(nd.max(initial=-1)) + 1)
        want = np.zeros((len(g), tc), np.int64)
        for e in range(len(g)):
            for t in range(tc):
                term = st["g_terms"][g[e], t]
                if w[e] == 0 or term < 0:
                    continue
                dom = nd[st["term_topo"][term], max(int(node[e]), 0)]
                want[e, t] = sizes[dom] if dom >= 0 else 0
        return want

    node = node.copy()
    node[np.flatnonzero(w != 0)[:3]] = -1  # node -1 reads node 0
    for statics in (t_statics, t_statics._replace(node_dom=torch.where(t_statics.node_dom >= 0,
                                                                       torch.arange(t_statics.node_dom.shape[0],
                                                                                    dtype=torch.int32)[:, None],
                                                                       t_statics.node_dom))):
        start = cuda.pair_starts(cuda._delta_setup(statics, t_state), g, node, w)
        want = direct(statics)
        assert start[0] == 0 and np.array_equal(np.diff(start), want.ravel())
        assert want.max() > 1 and (want[w == 0] == 0).all()
    assert want.max() == n  # one domain a key: every node


def test_statics_differing_only_in_fields_k7_does_not_read_share_one_setup(dense):
    """`_delta_setup` is keyed by the statics' tensors DeltaCtx reads: a
    node_valid mask (a capacity candidate's) shares the entry; other
    preference weights take a new one; a g_terms tensor keeps at most
    DELTA_SETUPS, the oldest dropped; K18's block comes from the same
    template."""
    _, _, t_statics, t_state, packed = _case(dense, "zone", 200, 13, None)
    statics = t_statics._replace(g_terms=t_statics.g_terms.clone())  # a cache of its own
    first = cuda._delta_setup(statics, t_state)
    rng = np.random.default_rng(13)
    for _ in range(3 * cuda.DELTA_SETUPS):
        valid = torch.from_numpy(rng.random(statics.node_valid.shape[0]) < 0.9)
        masked = statics._replace(node_valid=statics.node_valid & valid)
        assert cuda._delta_setup(masked, t_state) is first
    assert len(statics.g_terms._delta_setup) == 1
    for _ in range(cuda.DELTA_SETUPS + 2):
        weighted = statics._replace(**dict(zip(("w_aff_pref", "w_anti_pref"),
                                               map(torch.from_numpy, _weights(statics, rng, (100,))))))
        assert cuda._delta_setup(weighted, t_state) is not first
    kept = statics.g_terms._delta_setup
    assert len(kept) == cuda.DELTA_SETUPS and all(v is not first for v in kept.values())
    # K18's block: the template's dims and statics with the entries'
    # pointers; no pair starts, no pref_seen, mode -1
    up = cuda.upload_entries(packed["simtpu_torch", -1.0], torch.device("cpu"))
    ctx = cuda.make_delta_ctx(statics, t_state, up)
    tpl = cuda._delta_setup(statics, t_state)["template"]
    assert [getattr(ctx, f) for f in ("n", "r", "tc", "ti", "node_dom", "dom_start")] == \
        [getattr(tpl, f) for f in ("n", "r", "tc", "ti", "node_dom", "dom_start")]
    assert ctx.e == 256 and ctx.g == up["g"].data_ptr() and ctx.free == t_state.free.data_ptr()
    assert ctx.pair_start is None and ctx.pair_hint is None and ctx.pref_seen is None
    assert ctx.pref == -1 and ctx.work == 0
    with pytest.raises(ValueError, match="entries"):
        cuda.make_delta_ctx(statics, t_state, {**up, "req": up["req"][:, :1].contiguous()})


def test_pref_mode_is_set_and_cleared_on_the_right_statics(dense):
    _, t_eng = dense["zone"]
    statics = tscan.statics_from(t_eng.tensorizer.freeze(), None, "cpu")
    rng = np.random.default_rng(3)
    zero = torch.zeros_like(statics.w_aff_pref)
    none = statics._replace(w_aff_pref=zero, w_anti_pref=zero.clone())
    ints = statics._replace(**dict(zip(("w_aff_pref", "w_anti_pref"),
                                       map(torch.from_numpy, _weights(statics, rng, (100,))))))
    assert (ints.w_aff_pref != 0).any()
    frac = statics._replace(**dict(zip(("w_aff_pref", "w_anti_pref"),
                                       map(torch.from_numpy, _weights(statics, rng, FRACTIONAL)))))
    assert cuda.pref_mode(none, 256) == -1
    assert cuda.pref_mode(ints, 256) == cuda.F32_EXACT - 256 * 100
    assert cuda.pref_mode(ints, 200_000) == 0  # E x the largest |weight| past 2^24
    assert cuda.pref_mode(frac, 4) == 0
    # one weight plane alone decides it too
    half = none._replace(w_anti_pref=frac.w_anti_pref)
    assert cuda.pref_mode(half, 4) == 0
    nan = none._replace(w_aff_pref=torch.full_like(zero, float("nan")))
    assert cuda.pref_mode(nan, 4) == 0
    # computed once per pair of weight planes, kept on the first
    kept = ints.w_aff_pref._pref_weights
    assert kept[0] is ints.w_anti_pref and kept[1] == (True, True, 100.0)
    assert cuda.pref_weights(none) == (False, True, 0.0)  # `half` shares its first plane


# -- 4. the wrapper ------------------------------------------------------------


def test_the_k7_wrapper_passes_its_plan_the_domains_and_one_upload(monkeypatch, dense):
    _, _, t_statics, t_state, packed = _case(dense, "zone", 200, 5, tuple(range(1, 101)))
    libs = {name: _FakeLib() for name in cuda.KERNELS}
    monkeypatch.setattr(cuda, "build", lambda: libs)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(cuda, "LAUNCHES", Counter())
    cuda.launch_delta(t_statics, t_state, packed["simtpu_torch", -1.0])
    assert cuda.LAUNCHES == {"delta_apply": 1}
    (name, (ctx, plan, stream)), = libs["delta_apply"].calls
    ctx, plan = ctx._obj, plan._obj
    n, e = t_state.free.shape[0], 256
    width = ctx.r + ctx.p_ports + 2 * ctx.w + ctx.v + ctx.sd + ctx.gd
    g, node, w = packed["simtpu_torch", -1.0][:3]
    start = cuda.pair_starts(cuda._delta_setup(t_statics, t_state), g, node, w)
    assert ctx.work == start[-1] > (w != 0).sum()  # zones of several nodes
    want = cuda.compact_delta_plan(n, e, t_statics.g_terms.shape[1], width, work=ctx.work,
                                   pref_rows=t_state.cnt_own_anti.shape[0])
    assert name == "simtpu_delta_apply" and stream == 7 and ctx.e == e and cuda.delta_plan_of(ctx) == want
    fields = [f for f, _ in cuda.DeltaPlan._fields_ if f != "scratch"]
    assert {f: getattr(plan, f) for f in fields} == {f: want[f] for f in fields} and want["pref_blocks"] > 0
    assert ctx.pref == cuda.F32_EXACT - e * cuda.pref_weights(t_statics)[2] and ctx.ti == t_state.cnt_own_anti.shape[0]
    dom_start, dom_nodes = cuda.domain_nodes(t_statics.node_dom)
    assert ctx.dom_start == dom_start.data_ptr() and ctx.dom_nodes == dom_nodes.data_ptr()
    assert ctx.node_dom == t_statics.node_dom.data_ptr() and ctx.free == t_state.free.data_ptr()
    # the seven entry arrays, the pair starts and hints and the zeroed
    # pref_seen word in the one upload the wrapper returns
    ctx, _, up = cuda.delta_apply_call(t_statics, t_state, packed["simtpu_torch", -1.0])
    ptrs = [getattr(ctx, f) for f, _ in cuda.ENTRY_FIELDS] + [ctx.pair_start, ctx.pair_hint, ctx.pref_seen]
    base = up.data_ptr()
    assert all(p % 16 == 0 for p in ptrs) and ptrs == sorted(ptrs) and ptrs[0] == base
    assert ptrs[-1] + 4 <= base + up.numel()
    at = ctx.pair_start - base
    assert np.array_equal(up[at:at + start.nbytes].view(torch.int64).numpy(), start)
    hint = cuda.pair_hints(start)
    at = ctx.pair_hint - base
    assert np.array_equal(up[at:at + hint.nbytes].view(torch.int32).numpy(), hint)
    assert up[ctx.pref_seen - base:ctx.pref_seen - base + 4].view(torch.int32).tolist() == [0]
    for (f, dt), a in zip(cuda.ENTRY_FIELDS, packed["simtpu_torch", -1.0]):
        at = getattr(ctx, f) - base
        got = up[at:at + np.asarray(a).size * torch.empty(0, dtype=dt).element_size()].view(dt)
        assert np.array_equal(got.numpy().ravel(), np.asarray(a).ravel()), f
    # no preference weight: no preference blocks, mode -1
    zero = torch.zeros_like(t_statics.w_aff_pref)
    bare = t_statics._replace(w_aff_pref=zero, w_anti_pref=zero.clone())
    ctx, _, _ = cuda.delta_apply_call(bare, t_state, packed["simtpu_torch", -1.0])
    assert ctx.pref == -1 and cuda.delta_plan_of(ctx)["pref_blocks"] == 0
    # the kernel takes signs only
    bad = list(packed["simtpu_torch", -1.0])
    bad[2] = np.where(bad[2] != 0, F32(2.0), F32(0.0))
    with pytest.raises(ValueError, match="weight -1, 0 or \\+1"):
        cuda.launch_delta(t_statics, t_state, tuple(bad))
    assert cuda.LAUNCHES == {"delta_apply": 1}


def test_the_grouping_and_walk_live_once_in_the_shared_header():
    """K7 and K13 instantiate delta_runs.cuh's plan checks, grouping block,
    walk and launch (K7 with f32 count planes, K13 with int32); neither
    source holds a copy of them, and K7's per-node-thread walk over every
    entry is gone."""
    runs = (cuda.CSRC / "delta_runs.cuh").read_text()
    rows = (cuda.CSRC / "delta_rows.cuh").read_text()
    shared = ("struct DeltaPlan {", "struct DeltaRuns {", "struct DeltaGroup {", "int block_scan(",
              "void delta_group(", "void delta_group_block(", "void delta_walk(", "bool delta_plan_ok(",
              "int delta_launch(")
    for name, source in (("delta_apply", "delta_rows(x), p, x.e"), ("compact_delta", "delta_rows(x), p, x.e")):
        text = (cuda.CSRC / f"{name}.cu").read_text()
        assert '#include "delta_runs.cuh"' in text, name
        assert "delta_group_block(x, p, dsm)" in text and f"delta_walk({source}" in text, name
        assert "delta_plan_ok(q, x.n, x.e" in text and f"delta_launch({name}_kernel, {name}_walk_kernel" in text
        for piece in shared + ("atomicMin(", "__popc(", "atomicOr("):
            assert piece not in text, (name, piece)
    for piece in shared:
        assert runs.count(piece) == 1, piece
    assert "DeltaRows<float> delta_rows(const DeltaCtx& x)" in (cuda.CSRC / "delta_apply.cu").read_text()
    assert "DeltaRows<int> delta_rows(const CompactCtx& x)" in (cuda.CSRC / "compact_delta.cu").read_text()
    # the per-entry update of a node's rows, which K7's old node threads ran
    # over every entry, is gone: the walk's operands are the one arithmetic
    assert "delta_node_rows" not in rows and "delta_node_operand" in rows
    assert "for (int e = 0; e < x.e; ++e)" not in (cuda.CSRC / "delta_apply.cu").read_text()
