"""The callable a graphed chunk captures, run on the CPU without a graph
(``loop.make_step_runner(graph=loop.BODY)``): the SVAE train step reading
its per-step scalars from device tables and its minibatch, ε and Philox
word from the chunk's static stacks, one row a step.

* against the eager loop (``graph=False``), bit for bit (``torch.equal``):
  full batch, minibatches with and without replacement, augmentation,
  ρ decay, AdamW, the plain engine, and a chunk split 2 + 3 against 5;
* against the JAX package's ``make_minibatch_scan_runner`` over the JAX
  train step, the same ε and the same minibatch indices injected into
  both: in float64 at rtol 1e-10, in float32 at
  tests/test_torch_tinystep.py's bars (as tests/test_torch_adamw.py);
* the scalar tables: over steps 0–T, each row equal as float32, bit for
  bit, to the Python scalar the eager step computes, and the operations
  that read them (Adam's division through ``graph.divide``, CVI's
  products) give the eager results bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import svae as jsvae
from svax.models.svae import SvaeConfig as JConfig
from svax.pgm import gmm as jgmm
from svax.train import loop as jloop
from svax.train import svae_step as jstep
from svax_torch import convert
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm, natgrad
from svax_torch.train import graph, loop, svae_step

torch.set_num_threads(1)
N, D, K, HIDDEN, LR = 40, 3, 4, (8, 8), 1e-2


def _setup(dtype=torch.float32, **config):
    x = torch.tensor(np.random.default_rng(0).standard_normal((N, D)), dtype=dtype)
    cfg = SvaeConfig(latent_dim=2, num_components=K, num_samples=2, num_total=N,
                     fused_combine=True, kernel_rng=True, **config)
    prior = gmm.make_prior(K, 2, kappa=0.05, dtype=dtype)
    state = svae_step.init_state(torch.Generator().manual_seed(1), D, cfg, prior, HIDDEN,
                                 HIDDEN)
    return x, cfg, prior, state


def _chunks(route, x, cfg, prior, state, chunks, seed=5, **kw):
    run = loop.make_step_runner(cfg, prior, lr=LR, graph=route, **kw)
    mets = []
    for t in chunks:
        state, m = run(state, x, t, seed=seed)
        mets.append(m)
    return state, mets


def _equal(a, b) -> bool:
    la, lb = graph.flatten(a)[0], graph.flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(p, q) if torch.is_tensor(p) else p == q for p, q in zip(la, lb))


CASES = {
    "full-batch": dict(rho=0.3),
    "minibatch": dict(rho=0.3, batch_size=8),
    "without-replacement": dict(rho=0.3, batch_size=8, replace=False),
    "augmented": dict(rho=0.3, batch_size=8, aug_noise=0.3),
    "rho-decay": dict(rho=0.3, rho_decay=0.1, batch_size=8),
    "adamw": dict(rho=0.2, weight_decay=1e-3, batch_size=8),
    "plain-engine": dict(rho=0.2, rho_decay=0.05, batch_size=8, engine="plain",
                         aug_noise=0.2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_table_step_equals_the_eager_loop(case):
    x, cfg, prior, state = _setup()
    kw = CASES[case]
    eager = _chunks(False, x, cfg, prior, state, (2, 3), **kw)
    body = _chunks(loop.BODY, x, cfg, prior, state, (2, 3), **kw)
    assert _equal(eager, body)
    assert body[0].step == 5 and body[0].opt_state.count == 5


def test_a_split_chunk_equals_one_chunk_on_the_injected_noise():
    """2 + 3 against 5 with ε injected: what a chunk boundary may change is
    the chunk's draws only, and with ε given there are none but the
    indices of a full batch (none)."""
    x, cfg, prior, state = _setup()
    eps = torch.tensor(np.random.default_rng(3).standard_normal((5, 2, N, K, 2)),
                       dtype=torch.float32)
    run = loop.make_step_runner(cfg, prior, lr=LR, rho=0.3, rho_decay=0.1, graph=loop.BODY)
    split, m1 = run(state, x, 2, eps=eps[:2])
    split, m2 = run(split, x, 3, eps=eps[2:])
    whole, mw = loop.make_step_runner(cfg, prior, lr=LR, rho=0.3, rho_decay=0.1,
                                      graph=loop.BODY)(state, x, 5, eps=eps)
    assert _equal(split, whole)
    assert all(torch.equal(torch.cat([m1[k], m2[k]]), mw[k]) for k in mw)
    eager, me = loop.make_step_runner(cfg, prior, lr=LR, rho=0.3, rho_decay=0.1,
                                      graph=False)(state, x, 5, eps=eps)
    assert _equal(eager, whole) and all(torch.equal(me[k], mw[k]) for k in mw)


# ----------------------------------------------------- against the JAX scan


class _InjectedEps:
    """svax.models.svae as make_train_step's ``model``, the batch carrying
    (x, ε) (tests/test_torch_adamw.py's)."""

    @staticmethod
    def forward(nn, nat, prior, batch, key, config, axis_comp=None):
        x, eps = batch
        return jsvae.forward(nn, nat, prior, x, key, config, eps=eps, axis_comp=axis_comp)


F32_TOL = {"params": (5e-4, 5e-5), "mu": (5e-4, 5e-6), "nu": (5e-4, 1e-8),
           "nat": (2e-5, 2e-5)}
F64_TOL = {g: (1e-10, 1e-12) for g in F32_TOL}


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL), (jnp.float64, F64_TOL)])
def test_table_step_matches_the_jax_scan_runner(dtype, tol):
    t_steps, m, s, rho0, decay = 5, 16, 2, 0.2, 0.05
    x = jnp.asarray(make_pinwheel_data(num_classes=3, num_per_class=20, seed=0)[:60], dtype)
    n = x.shape[0]
    jconfig = JConfig(latent_dim=2, num_components=K, num_samples=s, num_total=n,
                      nn_precision=jax.lax.Precision.HIGHEST)
    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    jprior = cast(jgmm.make_prior(K, 2, kappa=0.05))
    opt = optax.adam(LR)
    jstate = cast(jstep.init_state(jax.random.PRNGKey(0), 2, jconfig, jprior, opt, HIDDEN,
                                   HIDDEN, data=x))
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=tdtype)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=tdtype)
    config = SvaeConfig(latent_dim=2, num_components=K, num_samples=s, num_total=n,
                        nn_precision="highest")
    eps = np.random.default_rng(7).standard_normal((t_steps, s, m, K, 2)).astype(
        np.float64 if dtype == jnp.float64 else np.float32)
    xt = torch.tensor(np.asarray(x))
    # The indices the port's runner draws for this chunk (seed + step 0),
    # injected into the JAX scan as its batch stack.
    idx = loop.minibatch_indices(torch.Generator().manual_seed(9), n, m, t_steps).numpy()
    runner = loop.make_step_runner(config, prior, lr=LR, rho=rho0, rho_decay=decay,
                                   batch_size=m, graph=loop.BODY)
    got, _ = runner(state, xt, t_steps, seed=9, eps=torch.tensor(eps))
    jstep_fn = jstep.make_train_step(jconfig, jprior, opt,
                                     lambda t: rho0 / (1.0 + decay * t), model=_InjectedEps)
    jrun = jloop.make_minibatch_scan_runner(jstep_fn, t_steps)
    want, _ = jrun(jstate, (x[idx], jnp.asarray(eps)), jax.random.PRNGKey(0))
    got, want = convert.state_to_numpy(got), jax.tree.map(np.asarray, want)
    adam = want.opt_state[0]
    for name, g, w in (("params", got["nn_params"], want.nn_params),
                       ("mu", got["adam"]["mu"], adam.mu), ("nu", got["adam"]["nu"], adam.nu)):
        rtol, atol = tol[name]
        for side in ("encoder", "decoder"):
            for gl, wl in zip(g[side], w[side]):
                for key in ("w", "b"):
                    np.testing.assert_allclose(gl[key], wl[key], rtol=rtol, atol=atol,
                                               err_msg=f"{name} {side} {key}")
    rtol, atol = tol["nat"]
    np.testing.assert_allclose(got["pgm_nat"]["dir_nat"], want.pgm_nat.dir_nat, rtol=rtol,
                               atol=atol)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got["pgm_nat"][f], getattr(want.pgm_nat.niw_nat, f),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert got["adam"]["count"] == int(adam.count) == t_steps
    assert got["step"] == int(want.step) == t_steps


# -------------------------------------------------------- the scalar tables


@pytest.mark.parametrize("start", [0, 7, 1000])
def test_tables_hold_the_eager_scalars_as_float32(start):
    t_steps, rho = 6, svae_step.rho_schedule(0.3, 0.01)
    tables = graph.Tables(t_steps, "cpu")
    tables.load({0: start, 1: start + 3}, t_steps)
    like = torch.zeros((), dtype=torch.float32)
    fns = {"adam_bias1": (lambda c: 1.0 - svae_step.B1**(c + 1), 0),
           "adam_bias2": (lambda c: 1.0 - svae_step.B2**(c + 1), 0),
           "rho": (lambda s: float(rho(s)), 1),
           "one_minus_rho": (lambda s: 1.0 - float(rho(s)), 1)}
    x = torch.tensor(np.random.default_rng(2).standard_normal(64), dtype=torch.float32)
    for t in range(t_steps):
        tables.ctr.fill_(t)
        for name, (fn, path) in fns.items():
            row = tables.row(name, fn, graph.Tick(start + 3 * path, path), like)
            eager = fn(start + 3 * path + t)
            assert torch.equal(row, torch.tensor(eager, dtype=torch.float32)), (name, t)
            # The eager step's operations on a Python scalar and the table
            # step's on the row agree bit for bit: CVI's products, and Adam's
            # division through graph.divide (a division on the CPU; on CUDA
            # a product by the reciprocal's row, tests/test_torch_cuda_graphs.py).
            assert torch.equal(row * x, eager * x)
            graph._active = tables
            try:
                got = graph.divide([x], name, fn, graph.Tick(start + 3 * path, path), like)[0]
            finally:
                graph._active = None
            assert torch.equal(got, torch._foreach_div([x], eager)[0]), (name, t)


def test_cvi_update_reads_one_minus_rho_as_the_eager_update_forms_it():
    _, _, prior, state = _setup()
    nat = state.pgm_nat
    rho = 0.3 / (1.0 + 0.01 * 17)
    eager = natgrad.cvi_update(nat, prior, prior, rho)
    tabled = natgrad.cvi_update(nat, prior, prior, torch.tensor(rho, dtype=torch.float32),
                                torch.tensor(1.0 - rho, dtype=torch.float32))
    assert _equal(eager, tabled)


def test_a_scalar_from_a_computed_int_is_refused():
    tables = graph.Tables(4, "cpu")
    tables.load({0: 3}, 4)
    with pytest.raises(ValueError, match="int leaf"):
        tables.row("rho", float, 3 + 1, torch.zeros(()))
    assert graph.scalar("rho", lambda s: s / 2, 3, torch.zeros(())) == 1.5
