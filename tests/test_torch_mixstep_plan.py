"""The redesigned mixstep kernel's plan and arithmetic order, on the CPU.

* ``mixstep.train_chunk_mirror`` — the kernel's step in float32 in its own
  order: per point its K log ρ once, the logsumexp and the weighted
  statistics; each warp's statistics by its shuffle tree, batch after
  batch; the warps' partials in warp order; the CVI update and the next
  log-ρ coefficients — against ``svax/ops/mixstep_pallas.train_chunk`` run
  by the Pallas interpreter at tests/test_mixstep_kernel.py's bars
  (naturals rtol 3e-4 atol 3e-4; local evidence rtol 2e-4 atol 2e-3), GMM
  and SMM, and against the port's plain version at the same bars;
* the shuffle tree ``_lane_tree`` against a lane-by-lane emulation of the
  kernel's transposing reduction (csrc/mixstep.cu: transpose_reduce), bit
  for bit;
* the plan at the shape class's edges (N = 1, 31, 400, 16,384; K = 1, 10,
  64): every point owned once, every statistic one slot, every component
  one 8-lane group, shared memory within the card's 232,448 bytes.

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_mixture.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import gmm_baseline as jgmm_baseline
from svax.ops import mixstep_pallas as msp
from svax.pgm import gmm as jgmm
from svax_torch import convert
from svax_torch.models.smm_baseline import SmmTrainState
from svax_torch.ops import mixstep

torch.set_num_threads(1)

NAT_TOL = dict(rtol=3e-4, atol=3e-4)
EVID_TOL = dict(rtol=2e-4, atol=2e-3)


def _setup(n, k, seed=0):
    x = np.asarray(make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5),
                                      seed=seed)[:n], np.float32)
    jprior = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jgmm.make_prior(k, 2, kappa=0.05))
    jstate = jgmm_baseline.init_state(jax.random.PRNGKey(seed), jprior, jnp.asarray(x))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    prior = convert.gmm_nat_from_numpy(to_np(jprior))
    state = convert.mixture_state_from_numpy(to_np(jstate))
    return x, jprior, jstate, prior, state


def _leaves(nat):
    return [nat.dir_nat, *nat.niw_nat]


@pytest.mark.parametrize("case", [
    dict(n=72, k=5, rho=0.3, t=6),                         # the GMM
    dict(n=600, k=10, rho=0.5, t=3, seed=3),               # two point batches, ragged
    dict(n=72, k=5, rho=0.4, t=4, num_total=144, seed=2),  # num_total scaling
    dict(n=72, k=5, rho=0.3, t=5, dof=4.0, seed=4),        # the SMM
    dict(n=600, k=9, rho=0.3, t=3, dof=4.0, seed=1),       # the SMM, three groups
], ids=["gmm", "two_batches", "num_total", "smm", "smm_two_batches"])
def test_mirror_matches_pallas_interpret(case):
    seed, dof = case.get("seed", 0), case.get("dof", 0.0)
    x, jprior, jstate, prior, state = _setup(case["n"], case["k"], seed)
    if dof > 0.0:
        state = SmmTrainState(nat=state.nat, step=0)
    kw = dict(rho=case["rho"], t_steps=case["t"], num_total=case.get("num_total"), dof=dof)
    st, mets = mixstep.train_chunk_mirror(state, prior, torch.tensor(x), **kw)
    jst, jmets = msp.train_chunk(jstate, jprior, jnp.asarray(x), interpret=True, **kw)
    got = convert.gmm_nat_to_numpy(st.nat)
    np.testing.assert_allclose(got["dir_nat"], np.asarray(jst.nat.dir_nat), **NAT_TOL)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jst.nat.niw_nat, f)),
                                   err_msg=f, **NAT_TOL)
    np.testing.assert_allclose(mets["local_evidence"].numpy(),
                               np.asarray(jmets["local_evidence"]), **EVID_TOL)
    assert st.step == case["t"] and type(st) is type(state)


@pytest.mark.parametrize("n,k,dof", [(400, 10, 0.0), (400, 10, 4.0), (1100, 64, 0.0),
                                     (31, 1, 4.0)])
def test_mirror_matches_plain(n, k, dof):
    x, _, _, prior, state = _setup(n, k, seed=n % 7)
    kw = dict(rho=0.3, t_steps=4, dof=dof)
    st, mets = mixstep.train_chunk_mirror(state, prior, torch.tensor(x), **kw)
    ref, ref_mets = mixstep.train_chunk_plain(state, prior, torch.tensor(x), **kw)
    for a, b in zip(_leaves(st.nat), _leaves(ref.nat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **NAT_TOL)
    np.testing.assert_allclose(mets["local_evidence"].numpy(),
                               ref_mets["local_evidence"].numpy(), **EVID_TOL)


def _transpose_reduce(values: np.ndarray) -> np.ndarray:
    """csrc/mixstep.cu's transpose_reduce, lane by lane: values (32 lanes,
    32) float32 → lane i's v[0] after the five levels."""
    v = values.astype(np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        new = v.copy()
        for lane in range(32):
            up = bool(lane & o)
            partner = lane ^ o
            for i in range(o):
                keep = v[lane, i + o] if up else v[lane, i]
                send = v[partner, i] if bool(partner & o) else v[partner, i + o]
                new[lane, i] = np.float32(keep + send)
        v = new
    return v[:, 0]


def test_lane_tree_is_the_kernels_transposing_reduction():
    rng = np.random.default_rng(0)
    values = (rng.standard_normal((32, 32)) * 10.0 ** rng.integers(-3, 4, (32, 32))
              ).astype(np.float32)
    want = _transpose_reduce(values)
    got = mixstep._lane_tree(torch.tensor(values)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dof", [0.0, 4.0])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("n", [1, 31, 400, 16384])
def test_plan_at_the_shape_class_edges(n, k, dof):
    assert n <= mixstep.MAX_POINTS and k <= mixstep.MAX_COMPONENTS
    owners = {mixstep.point_owner(p) for p in range(n)}
    assert len(owners) == n
    assert all(0 <= w < mixstep.WARPS and 0 <= lane < 32 for _, w, lane in owners)
    assert max(j for j, _, _ in owners) == (n - 1) // mixstep.THREADS
    c_count, cpg = mixstep.stat_slots(dof)
    assert c_count * cpg <= 32
    g = mixstep.stat_groups(k, dof)
    slots = {mixstep.stat_slot(kk, c, dof) for kk in range(k) for c in range(c_count)}
    assert len(slots) == k * c_count and max(slots) < g * 32
    lanes = {}
    for kk in range(k):
        warp, group = mixstep.component_lanes(kk)
        assert 0 <= warp < mixstep.WARPS and group.start >= 0 and group.stop <= 32
        for lane in group:
            assert (warp, lane) not in lanes
            lanes[(warp, lane)] = kk
    assert mixstep.smem_bytes(k, dof) <= 232448
