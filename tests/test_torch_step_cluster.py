"""The whole-step kernels' cluster engine, on the CPU.

* ``cluster_plan`` of tinystep and flexstep (the mirror of
  csrc/cluster_step.cuh: part_begin) gives every point, (n, k) record,
  decoder row and parameter to exactly one CTA, for C ∈ {8, 16}, at the
  configs' shapes, ragged N, N < C and K = 1;
* the Python twins of the kernels' shared-memory budgets stay within the
  227 KB a CTA can have for every shape the shape gates accept;
* the gates accept exactly the shapes they accepted before the cluster
  design (the rules written out here), on grids around their limits;
* the engine's order of summation — per-CTA partials over the CTA's rows,
  added in rank order — emulated in float64 here (``step_grads_manual`` on
  each CTA's points of the ``cluster_plan``, the partials added in rank
  order), gives autograd's gradients at the f64 bars of
  tests/test_torch_tinystep.py and tests/test_torch_flexstep.py, and the
  whole batch's ``step_grads_manual`` statistics: the reordering is only a
  reordering.
"""

import itertools

import numpy as np
import pytest
import torch

from svax_torch.models import svae, svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import flexstep, tinystep
from svax_torch.pgm import gmm
from svax_torch.train import svae_step

torch.set_num_threads(1)

CLUSTERS = (8, 16)
P_PINWHEEL = 2 * (2 * 50 + 50 + 50 * 50 + 50 + 50 * 4 + 4)  # 50-50 sides
P_16 = 2 * (2 * 16 + 16 + 16 * 16 + 16 + 16 * 4 + 4)


def _covers(plan, n, k, s, p, rows_total):
    for key, total in (("points", n), ("records", n * k), ("params", p)):
        seen = [i for part in plan for i in part[key]]
        assert sorted(seen) == list(range(total)), key
    rows = [i for part in plan for rng in part["rows"] for i in rng]
    assert sorted(rows) == list(range(rows_total))
    # Each CTA's records and rows are those of its own points.
    for part in plan:
        assert all(q // k in part["points"] for q in part["records"])


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("n,k,s,p", [
    (400, 10, 4, P_PINWHEEL),  # pinwheel-svae (and its --smm-dof: the same cut)
    (400, 10, 4, P_16),        # the 16-16 instantiation
    (37, 4, 2, P_16),          # ragged N
    (5, 3, 2, P_16),           # N < C: CTAs with no point
    (72, 1, 2, P_16),          # K = 1
], ids=["pinwheel", "16-16", "ragged_n37", "n5", "k1"])
def test_tinystep_plan_covers_everything_once(cluster, n, k, s, p):
    plan = tinystep.cluster_plan(n, k, s, p, cluster)
    assert len(plan) == cluster
    _covers(plan, n, k, s, p, s * n * k)
    for part in plan:  # each sample's rows of a CTA are one run of n·K + k
        for si, rng in enumerate(part["rows"]):
            assert [(r - si * n * k) // k for r in rng] == [
                q // k for q in part["records"]]
    sizes = [len(part["points"]) for part in plan]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == -(-n // cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("m,d_in,d,k,s,h", [
    (64, 8, 4, 10, 4, 100),  # auto-svae
    (32, 3, 2, 5, 2, 16),    # d = 2
    (32, 8, 6, 3, 2, 24),    # d = 6
    (37, 8, 4, 4, 2, 16),    # ragged M
    (5, 8, 4, 3, 2, 16),     # M < C
    (37, 2, 2, 1, 2, 16),    # K = 1
], ids=["auto", "d2", "d6", "ragged_m37", "m5", "k1"])
def test_flexstep_plan_covers_everything_once(cluster, m, d_in, d, k, s, h):
    p = flexstep.n_params(d_in, d, h, h, h, h)
    plan = flexstep.cluster_plan(m, k, s, p, cluster)
    assert len(plan) == cluster
    _covers(plan, m, k, s, p, m * k * s)
    for part in plan:  # the kernel's row (n·K + k)·S + s belongs to point n
        assert all(r // (k * s) in part["points"] for rng in part["rows"] for r in rng)


def test_flexstep_n_params_counts_the_flat_vector():
    gen = torch.Generator().manual_seed(0)
    for d_in, d, hid in ((8, 4, (100, 100, 100, 100)), (3, 6, (24, 40, 7, 128))):
        config = SvaeConfig(latent_dim=d, num_components=3, num_samples=2, num_total=10)
        state = svae_step.init_state(gen, d_in, config, gmm.make_prior(3, d), hid[:2],
                                     hid[2:])
        assert flexstep.n_params(d_in, d, *hid) == tinystep.flat_params(
            state.nn_params).numel()


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_smem_budgets_fit_every_accepted_shape(cluster):
    for (h1, h2), k in itertools.product(tinystep.SUPPORTED_HIDDEN,
                                         range(1, tinystep.MAX_COMPONENTS + 1)):
        assert tinystep.smem_bytes(h1, h2, k, cluster) <= tinystep.SMEM_LIMIT
    # flexstep's budget grows with every size: its grid holds each limit.
    widths = (1, 17, 64, 127, flexstep.MAX_HIDDEN)
    for d, d_in, k in itertools.product(flexstep.LATENT_DIMS, (1, 5, flexstep.MAX_INPUT),
                                        (1, 33, flexstep.MAX_COMPONENTS)):
        for h1e, h2e, h1d, h2d in itertools.product(widths, repeat=4):
            assert flexstep.smem_bytes(d_in, d, k, h1e, h2e, h1d, h2d,
                                       cluster) <= flexstep.SMEM_LIMIT
    # The largest: parameters 38,684 floats, moments 192/C KB of them.
    top = flexstep.smem_bytes(8, 6, 64, 128, 128, 128, 128, cluster)
    assert top == 4 * (38684 + 2 * ((-(-38684 // cluster) + 3) // 4 * 4) + 2 * 2880 + 2756)


def test_smem_budgets_match_the_kernels_regions():
    """The budgets at the configs' shapes, region by region (tinystep.cu:
    Shape::smem_floats; flexstep.cu: Smem)."""
    tile = (3 + 51 + 51 + 52 + 52 + 4) * 36
    assert tinystep.smem_bytes(50, 50, 10, 16) == 4 * (
        2 * 5808 + 2 * 364 + 4 * 50 * 52 + 2 * 92 + 80 + 2 * 72 + tile)
    p = flexstep.n_params(8, 4, 100, 100, 100, 100)
    assert p == 24024
    assert flexstep.smem_bytes(8, 4, 10, 100, 100, 100, 100, 8) == 4 * (
        24024 + 2 * 3004 + 2 * 232 + 212)


def _meta_tiny(hidden_e, hidden_d, x_dim=2, latent=2, out=4, dec_out=4, k=10):
    def layer(i, o):
        return {"w": torch.empty(i, o, device="meta"), "b": torch.empty(o, device="meta")}
    enc = [layer(x_dim, hidden_e[0]), layer(hidden_e[0], hidden_e[1]), layer(hidden_e[1], out)]
    dec = [layer(latent, hidden_d[0]), layer(hidden_d[0], hidden_d[1]),
           layer(hidden_d[1], dec_out)]
    state = svae_step.SvaeTrainState(nn_params={"encoder": enc, "decoder": dec},
                                     opt_state=None, pgm_nat=None, step=0)
    prior = gmm.GmmNat(dir_nat=torch.empty(k, device="meta"), niw_nat=None)
    return state, prior


def test_tinystep_gate_accepts_what_it_accepted():
    """shape_class_reason: matched hidden widths in {16-16, 50-50}, 2-D data,
    latent 2 with a diagonal head, a Gaussian decoder, 1 ≤ K ≤ 32, S ≥ 1."""
    hiddens = [(16, 16), (50, 50), (50, 16), (20, 12), (64, 64), (49, 50)]
    for he, hd, k, s, x_dim, dec_out in itertools.product(
            hiddens, hiddens, (1, 2, 31, 32, 33), (0, 1, 4), (2, 3), (4, 6)):
        state, prior = _meta_tiny(he, hd, x_dim=x_dim, dec_out=dec_out, k=k)
        x = torch.empty(400, x_dim, device="meta")
        want = (he == hd and he in ((16, 16), (50, 50)) and x_dim == 2 and dec_out == 4
                and 1 <= k <= 32 and s >= 1)
        assert (tinystep.shape_class_reason(state, prior, x, s) is None) == want


def test_flexstep_gate_accepts_what_it_accepted():
    """unsupported_reason: 2 ≤ d ≤ 6, 1 ≤ d_in ≤ 8, a diagonal head, a
    Gaussian decoder head, hidden widths 1..128, 1 ≤ K ≤ 64, S, M ≥ 1."""
    def layer(i, o):
        return {"w": torch.empty(i, o, device="meta"), "b": torch.empty(o, device="meta")}

    for d, d_in, h, k, s, m in itertools.product((1, 2, 6, 7), (1, 8, 9), (1, 128, 129),
                                                 (1, 64, 65), (0, 1), (0, 1)):
        nn = {"encoder": [layer(d_in, h), layer(h, 100), layer(100, 2 * d)],
              "decoder": [layer(d, 100), layer(100, h), layer(h, 2 * d_in)]}
        prior = gmm.GmmNat(dir_nat=None, niw_nat=type("N", (), {
            "eta1": torch.empty(k, d, device="meta")})())
        want = (2 <= d <= 6 and 1 <= d_in <= 8 and 1 <= h <= 128 and 1 <= k <= 64
                and s >= 1 and m >= 1)
        assert (flexstep.unsupported_reason(nn, prior, (3, m, d_in), s) is None) == want


def _f64_tiny(n, k, s, hidden, seed):
    from svax_torch.data.pinwheel import make_pinwheel_data

    x = torch.tensor(make_pinwheel_data(num_classes=3, num_per_class=-(-n // 3),
                                        seed=seed)[:n], dtype=torch.float64)
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, 2, kappa=0.05, dtype=torch.float64)
    state = svae_step.init_state(torch.Generator().manual_seed(seed), 2, config, prior,
                                 hidden, hidden)
    eps = torch.tensor(np.random.default_rng(seed + 7).standard_normal((s, n, k, 2)))
    return x, config, prior, state, eps


def _autograd(state, prior, x, config, eps, forward):
    params = svae_step.map_params(lambda p: p.clone().requires_grad_(True), state.nn_params)
    out = forward(params, state.pgm_nat, prior, x, config, eps=eps)
    neg_loss = -(out.recon - out.local_kl) / config.num_total
    leaves = [t for side in params.values() for ly in side for t in ly.values()]
    return torch.autograd.grad(neg_loss, leaves), out


def _leaves(grads):
    return [t for side in grads.values() for ly in side for t in ly.values()]


def _in_rank_order(plan, partial):
    """Σ over the CTAs of the plan, in rank order, of partial(points) — a
    pytree of tensors (dicts and lists) per CTA that owns points."""
    total = None
    for part in plan:
        if len(part["points"]) == 0:
            continue
        got = partial(torch.arange(part["points"].start, part["points"].stop))
        total = got if total is None else _tree_add(total, got)
    return total


def _tree_add(a, b):
    if isinstance(a, dict):
        return {key: _tree_add(a[key], b[key]) for key in a}
    if isinstance(a, list):
        return [_tree_add(x, y) for x, y in zip(a, b)]
    return a + b


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("case", [
    dict(n=37, k=4, s=2, hidden=(16, 16)),
    dict(n=5, k=3, s=2, hidden=(16, 16)),
    dict(n=40, k=1, s=3, hidden=(16, 16)),
    dict(n=37, k=4, s=2, hidden=(16, 16), dof=4.0),
], ids=["ragged", "n5", "k1", "smm"])
def test_tinystep_rank_order_is_only_a_reordering(cluster, case):
    n = case["n"]
    x, config, prior, state, eps = _f64_tiny(n, case["k"], case["s"], case["hidden"], 0)
    dof = case.get("dof", 0.0)
    plan = tinystep.cluster_plan(n, case["k"], case["s"], 0, cluster)

    def partial(idx):
        # The CTA's points alone: its gradients carry 1/|idx| for 1/N.
        grads, aux = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x[idx],
                                                eps[:, idx], dof=dof)
        grads = svae_step.map_params(lambda g: g * (len(idx) / n), grads)
        return {"grads": grads, "aux": {key: v for key, v in aux.items()
                                        if key != "neg_loss"}}

    got = _in_rank_order(plan, partial)
    grads, aux = got["grads"], got["aux"]
    ref, ref_aux = tinystep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps, dof=dof)
    if dof > 0.0:
        config = config._replace(dof=dof, smm_iters=2)
        want, out = _autograd(state, prior, x, config, eps, svae_smm.forward)
    else:
        want, out = _autograd(state, prior, x, config, eps, svae.forward)
    for g, w in zip(_leaves(grads), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(float(aux["recon"]), float(out.recon.detach()), rtol=1e-9)
    np.testing.assert_allclose(float(aux["local_kl"]), float(out.local_kl.detach()),
                               rtol=1e-9)
    for key in ("counts", "u_counts", "s1_1", "s1_2", "s2_11", "s2_12", "s2_22"):
        np.testing.assert_allclose(aux[key].numpy(), ref_aux[key].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    for g, w in zip(_leaves(grads), _leaves(ref)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("d,k,m", [(4, 10, 64), (2, 1, 37), (6, 3, 5)])
def test_flexstep_rank_order_is_only_a_reordering(cluster, d, k, m):
    d_in, s, n = 8 if d >= 4 else d + 2, 3, 120
    gen = torch.Generator().manual_seed(d)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
    prior = gmm.make_prior(k, d, kappa=0.05, dtype=torch.float64)
    state = svae_step.init_state(gen, d_in, config, prior, (12, 9), (10, 7))
    x = torch.randn(m, d_in, generator=gen, dtype=torch.float64)
    eps = torch.randn(s, m, k, d, generator=gen, dtype=torch.float64)
    plan = flexstep.cluster_plan(m, k, s, 0, cluster)

    def partial(idx):
        # The CTA's rows alone, scaled by num_total/M as the whole batch's
        # are: num_total·|idx|/M in its own scale; its gradients carry
        # 1/num_total·M/|idx| for 1/num_total.
        share = n * len(idx) / m
        grads, aux = flexstep.step_grads_manual(state.nn_params, state.pgm_nat, x[idx],
                                                eps[:, idx], num_total=share)
        grads = svae_step.map_params(lambda g: g * (share / n), grads)
        return {"grads": grads, "aux": {key: v for key, v in aux.items()
                                        if key != "neg_loss"}}

    got = _in_rank_order(plan, partial)
    grads, aux = got["grads"], got["aux"]
    ref, ref_aux = flexstep.step_grads_manual(state.nn_params, state.pgm_nat, x, eps,
                                              num_total=n)
    want, out = _autograd(state, prior, x, config, eps, svae.forward)
    for g, w in zip(_leaves(grads), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)
    for g, w in zip(_leaves(grads), _leaves(ref)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(float(aux["recon"]), float(out.recon.detach()), rtol=1e-9)
    np.testing.assert_allclose(float(aux["local_kl"]), float(out.local_kl.detach()),
                               rtol=1e-9)
    for key in ("counts", "s1", "s2"):
        np.testing.assert_allclose(aux[key].numpy(), ref_aux[key].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
