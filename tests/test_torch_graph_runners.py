"""The graphed runners' other pieces on the CPU, where no graph can run:

* ``make_batch_runner``'s captured callable (``graph=loop.BODY``) against
  its eager loop, bit for bit, for the VAE step (augmented, its own ε from
  the runner's generator, minibatches), the GMM step (ρ decay from a
  table, with and without replacement), the estep kernel's plain version
  and the SMM step; ``run_mixture``'s chunks between two rows likewise;
* the launch-counter accounting: a stub step's counter increase times the
  replays equals the counts of as many eager calls;
* the routes: CPU tensors run eager, a sharded step runs eager, and the
  reason is the one the entries print;
* the train state's structure round trip and the graph key's ingredients.
"""

import numpy as np
import pytest
import torch

from svax_torch.data.pinwheel import load_pinwheel
from svax_torch.models import gmm_baseline, smm_baseline, vae
from svax_torch.ops import combine, decoder, estep
from svax_torch.pgm import gmm
from svax_torch.train import graph, loop, svae_step

torch.set_num_threads(1)


def _x(n=60, d=2, seed=0):
    return torch.tensor(np.random.default_rng(seed).standard_normal((n, d)),
                        dtype=torch.float32)


def _equal(a, b) -> bool:
    la, lb = graph.flatten(a)[0], graph.flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(p, q) if torch.is_tensor(p) else p == q for p, q in zip(la, lb))


def _chunks(make, state, x, chunks=(3, 4)):
    out = []
    for route in (False, loop.BODY):
        run, st, mets = make(route), state, []
        for t in chunks:
            st, m = run(st, x, t)
            mets.append(m)
        out.append((st, mets))
    return out


def _vae_runner(route, batch=16):
    cfg = vae.VaeConfig(latent_dim=2, num_samples=2)
    step = loop.augment_step(vae.make_train_step(cfg, 1e-2), 0.3)
    return loop.make_batch_runner(lambda s, xb, g: step(s, xb, generator=g),
                                  batch_size=batch, seed=4, noise=True, graph=route)


@pytest.mark.parametrize("batch", [0, 16])
def test_vae_table_step_equals_the_eager_loop(batch):
    x = _x(d=3)
    cfg = vae.VaeConfig(latent_dim=2, num_samples=2)
    state = vae.init_state(torch.Generator().manual_seed(0), 3, cfg, (8, 8), (8, 8))
    eager, body = _chunks(lambda r: _vae_runner(r, batch), state, x)
    assert _equal(eager, body)
    assert body[0].step == 7 and body[0].opt_state.count == 7


@pytest.mark.parametrize("kind,replace", [("gmm", True), ("gmm", False), ("estep", True),
                                          ("smm", True)])
def test_mixture_table_step_equals_the_eager_loop(kind, replace):
    x = _x()
    prior = gmm.make_prior(4, 2, kappa=0.05)
    rho = svae_step.rho_schedule(0.5, 0.1)
    if kind == "smm":
        state = smm_baseline.init_state(torch.Generator().manual_seed(0), prior, x)
        step = smm_baseline.make_train_step(prior, rho, num_total=60, dof=4.0)
    else:
        state = gmm_baseline.init_state(torch.Generator().manual_seed(0), prior, x)
        step = gmm_baseline.make_train_step(prior, rho, num_total=60, fused=kind == "estep")
    eager, body = _chunks(lambda r: loop.make_batch_runner(
        step, batch_size=20, seed=2, replace=replace, graph=r), state, x)
    assert _equal(eager, body)
    # The ρ metric is the schedule's, row by row.
    assert torch.equal(body[1][0]["rho"], torch.tensor([rho(t) for t in range(3)],
                                                       dtype=torch.float32))


def test_run_mixture_graphs_the_steps_between_rows():
    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32)
    prior = gmm.make_prior(10, 2, kappa=0.05)
    state = gmm_baseline.init_state(torch.Generator().manual_seed(0), prior, x)
    step = gmm_baseline.make_train_step(prior, svae_step.rho_schedule(1.0, 0.01),
                                        num_total=x.shape[0], fused=True)
    out = {}
    for route in (False, loop.BODY):
        rows = []
        st, _ = loop.run_mixture(state, x, steps=23, eval_every=5, step=step, graph=route,
                                 emit=lambda t, s, e: rows.append((t, e)))
        out[route] = (st, rows)
    assert _equal(out[False][0], out[loop.BODY][0])
    assert out[False][1] == out[loop.BODY][1]
    assert [t for t, _ in out[False][1]] == [1, 5, 10, 15, 20]


def test_launch_counts_times_replays_equal_the_eager_counts():
    """A stub step bumps the counters as the kernel wrappers do; the
    increase its one captured call makes, times T replays, is what T eager
    calls count."""
    def stub():
        combine.launches += 1
        combine.lean_backward_launches += 1
        combine.backward_paths["dz+dlr+dlocal"] = combine.backward_paths.get(
            "dz+dlr+dlocal", 0) + 1
        decoder.launches += 2
        estep.launches += 3

    saved = graph.launch_counts()
    try:
        for _ in range(7):
            stub()
        eager = graph.launch_counts()
        graph.restore_counts(saved)
        for _ in range(2):  # warm-up calls: restored away
            stub()
        warm = graph.launch_counts()
        stub()  # the capture's one call
        inc = graph.count_increase(warm, graph.launch_counts())
        graph.restore_counts(saved)
        graph.add_counts(inc, 7)
        assert graph.launch_counts() == eager
        assert inc[("decoder", "launches")] == 2
        assert inc[("combine", "backward_paths")] == {"dz+dlr+dlocal": 1}
    finally:
        graph.restore_counts(saved)


def test_routes_on_the_cpu():
    assert graph.route("cpu") == graph.CPU_EAGER
    assert graph.route("cuda", sharded=True) == graph.SHARDED_EAGER
    assert graph.route("cuda") == graph.GRAPHED
    assert graph.route("cuda", graph=False) == graph.ASKED_EAGER
    x = _x(d=3)
    cfg = vae.VaeConfig(latent_dim=2, num_samples=2)
    state = vae.init_state(torch.Generator().manual_seed(0), 3, cfg, (8, 8), (8, 8))
    assert _vae_runner(None).engine(x.device) is None  # CPU tensors: the eager loop
    assert _vae_runner(None)(state, x, 2)[0].step == 2
    with pytest.raises(ValueError, match="unknown graph"):
        loop.make_batch_runner(lambda s, b: (s, {}), graph=True)


def test_state_structure_round_trips():
    cfg = vae.VaeConfig(latent_dim=2, num_samples=2)
    state = vae.init_state(torch.Generator().manual_seed(0), 3, cfg, (8, 8), (8, 8))
    leaves, spec = graph.flatten(state)
    assert _equal(graph.unflatten(spec, leaves), state)
    ints = [v for v in leaves if isinstance(v, int)]
    assert ints == [0, 0]  # Adam's count and the step
    tick = graph.Tick(5, 3)
    assert tick == 5 and tick.path == 3 and type(tick + 1) is int
