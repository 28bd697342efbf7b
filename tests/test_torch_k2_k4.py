"""The port's K1→K4 plain chain against the JAX package's serial scan past
1024 nodes, where K2 (`kernels/csrc/topology_pod.cu`) runs as a
thread-block cluster over node tiles (`kernels/cuda.py topology_plan`).

The smoke problem's constraint mix (zone spread, half of it
DoNotSchedule; required and preferred anti-affinity; selectors,
tolerations) on 1100 nodes, a seeded placement log of 3000 entries for
the count planes, and 32 of its pods placed in order by both packages:
node, reason and every state plane equal, with the derived step flags and
with every flag on; and the term columns' table K2 and K4 stage
(`kernels/cuda.py column_table`) against the statics it is built from.
The card's side (the kernels against these plain
versions) is `chip_smoke.py` phase 19. All inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simtpu.core.tensorize import Tensorizer
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.synth import synth_apps, synth_cluster
from simtpu.workloads.expand import get_valid_pods_exclude_daemonset, seed_name_hashes
from simtpu_torch import smoke
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from ._threads import one_torch_thread  # noqa: F401 (autouse)

NODES = 1100
PODS = 32


def _numpy_tree(nt):
    return type(nt)(*(np.asarray(x) for x in nt))


@pytest.fixture(scope="module")
def wide_problem():
    cluster, apps = smoke.smoke_problem(synth_cluster, synth_apps, NODES, 400)
    seed_name_hashes(1)
    try:
        pods = [p for a in apps for p in get_valid_pods_exclude_daemonset(a.resource)]
    finally:
        seed_name_hashes(None)
    tz = Tensorizer(cluster.nodes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, arrays = jscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    rng = np.random.default_rng(11)
    sel = np.sort(rng.choice(len(arrays[0]), PODS, replace=False))
    arrays = tuple(np.asarray(x)[sel] for x in arrays)
    k = 3000
    state = jstate.build_state(
        tensors, rng.integers(0, len(tensors.groups), k).astype(np.int32),
        rng.integers(0, tensors.n_nodes, k).astype(np.int32), arrays[1][rng.integers(0, PODS, k)], None)
    return tensors, batch, jscan.statics_from(tensors), state, arrays


def test_column_table_equals_the_statics(wide_problem):
    # the table K2 and K4 stage (StepCtx g_cols) against the statics it is
    # built from: term, key row, interpod row, flag bits, weight bits
    tensors, _, statics, _, _ = wide_problem
    st = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    tab = cuda.column_table(st).numpy()
    g_terms = np.asarray(statics.g_terms)
    assert tab.shape == (g_terms.shape[0], cuda.TOPO_COL_WORDS, g_terms.shape[1]) and tab.dtype == np.int32
    live = g_terms >= 0
    safe = np.maximum(g_terms, 0)
    np.testing.assert_array_equal(tab[:, 0], g_terms)
    np.testing.assert_array_equal(tab[:, 1], np.where(live, np.asarray(statics.term_topo)[safe], -1))
    np.testing.assert_array_equal(tab[:, 2], np.where(live, np.asarray(statics.ip_of)[safe], -1))
    flags = sum(np.asarray(getattr(statics, name)).astype(np.int32) * bit for name, bit in cuda.TOPO_FLAG_BITS)
    np.testing.assert_array_equal(tab[:, 3], flags)
    for k, name in enumerate(("w_aff_pref", "w_anti_pref", "spread_hard", "spread_soft")):
        np.testing.assert_array_equal(tab[:, 4 + k], np.asarray(getattr(statics, name), np.float32).view(np.int32))
    # the problem's columns reach every word: live terms, interpod rows,
    # hard and soft spread, required and preferred terms
    assert live.any() and (tab[:, 2] >= 0).any() and (tab[:, 3] != 0).any()
    assert (np.asarray(statics.spread_hard) > 0).any() and (np.asarray(statics.w_anti_pref) != 0).any()
    # the argument block carries it, one per buffer
    buf = tscan.StepBuffers(st, tstate.state_from_numpy(_numpy_tree(wide_problem[3]), "cpu"), wide_problem[4],
                            tscan.StepFlags())
    ctx = cuda.make_ctx(buf)
    assert ctx.g_cols == buf.g_cols.data_ptr() and torch.equal(buf.g_cols, torch.as_tensor(tab))
    assert buf.group_host == np.asarray(wide_problem[4][0], np.int32).tolist()


@pytest.mark.parametrize("flag_set", ["derived", "general"])
def test_k1_to_k4_plain_chain_matches_jax_scan_past_1024_nodes(wide_problem, flag_set):
    tensors, batch, statics, state, pods = wide_problem
    assert cuda.topology_plan(tensors.n_nodes, 4)["launch"] == "cluster"
    jflags = jscan.flags_from(tensors, batch.ext) if flag_set == "derived" else jscan.StepFlags()
    j_state, (j_node, j_reason, *_) = jscan._run_scan(statics, jax.tree_util.tree_map(jnp.copy, state), pods, jflags)
    flags = tscan.StepFlags(**{k: v for k, v in jflags._asdict().items() if k in tscan.StepFlags._fields})
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods, flags)
    tscan.run_batch(buf)
    np.testing.assert_array_equal(buf.out_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(buf.reason.numpy(), np.asarray(j_reason))
    assert jstate.diff_state_planes(tstate.state_to_numpy(buf.state), _numpy_tree(j_state)) == []
    # the pods reach the hard-spread and inter-pod filters: some are placed,
    # and the group's term columns are live
    assert (np.asarray(j_node) >= 0).sum() >= PODS // 2
    assert int((np.asarray(statics.g_terms) >= 0).sum()) > 0
