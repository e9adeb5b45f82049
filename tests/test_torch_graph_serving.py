"""The graphed evaluation, serving and online rules on the CPU, where no
graph can run: each owner's captured callable run without a graph
(``graph="body"``: static inputs copied in, outputs cloned out, as a replay
does) against its eager route, bit for bit, and against the JAX package.

* ``graph.CallGraph``: its body route equals the direct call; one capture
  per key, a changed shape, constant or key captures anew; a request over
  two pieces at one bucket returns the rows of the two single requests
  (each run's outputs are cloned out of the static buffers);
* ``svae_step.make_eval_fn``: the body route equals the eager call for
  every noise route (in-kernel ε keyed by the state's step, a generator,
  injected ε; weighted and sampled estimators; the SMM prior; the full
  head) as the state and the step change, and matches the JAX
  ``make_eval_fn`` on injected ε at float64 rtol 1e-9
  (tests/test_torch_svae_smm.py's forward bar);
* ``serve.SvaeServer`` and ``ExportedServer``: every endpoint at buckets
  32 and 512, GMM and SMM bundles, body route against the eager route;
* ``latent_contamination_demo.run_online`` through
  ``ChunkGraph(graphed=False)`` against the eager loop, and both against
  the reference's online rules run by ``jax.lax.scan`` (1e-5,
  tests/test_torch_demos.py's bar);
* the printed and exposed routes.
"""

import contextlib
import io
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svax.data.pinwheel import make_pinwheel_data as jmake_pinwheel
from svax.models import svae as jsvae
from svax.models import svae_smm as jsvae_smm
from svax.models.svae import SvaeConfig as JConfig
from svax.nets import mlp as jnets
from svax.pgm import gmm as jgmm
from svax.pgm import natgrad as jnatgrad
from svax.pgm import smm as jsmm
from svax.train import svae_step as jstep
from svax_torch import convert, latent_contamination_demo, serve, train_svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm import gmm
from svax_torch.train import graph, svae_step
from svax_torch.utils.tree import flatten

torch.set_num_threads(1)
BODY = graph.BODY
HIGHEST = jax.lax.Precision.HIGHEST


def _equal(a, b) -> bool:
    la, lb = graph.flatten(a)[0], graph.flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(p, q) if torch.is_tensor(p) else p == q for p, q in zip(la, lb))


def _host_equal(a, b) -> bool:
    la, lb = [t for _, t in flatten(a)], [t for _, t in flatten(b)]
    return len(la) == len(lb) and all(np.array_equal(p, q) for p, q in zip(la, lb))


# ------------------------------------------------------------- CallGraph


def _affine(a):
    return {"y": a["x"] @ a["w"] + a["b"], "n": a["x"].abs().sum(dim=-1) * a["scale"]}


def _inputs(rows=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(rows, 3, generator=g), "w": torch.randn(3, 4, generator=g),
            "b": torch.randn(4, generator=g), "scale": 2.5}


def test_call_graph_body_route_equals_the_direct_call():
    eng = graph.CallGraph(graphed=False)
    for seed in range(3):  # the static buffers refilled each run
        got = eng.run(_inputs(seed=seed), _affine)
        assert _equal(got, _affine(_inputs(seed=seed)))
    assert len(eng.calls) == 1 and eng.captures == 0  # no graph on the body route


def test_call_graph_captures_once_per_key():
    eng = graph.CallGraph(graphed=False)
    eng.run(_inputs(), _affine)
    eng.run(_inputs(seed=1), _affine)
    assert len(eng.calls) == 1
    eng.run(_inputs(rows=6), _affine)  # another shape
    assert len(eng.calls) == 2
    eng.run({**_inputs(), "scale": 3.0}, _affine)  # another constant leaf
    assert len(eng.calls) == 3
    eng.run(_inputs(), _affine, key=("other",))  # another static argument
    assert len(eng.calls) == 4
    eng.run(_inputs(seed=2), _affine)
    assert len(eng.calls) == 4


def test_call_graph_clones_each_runs_outputs():
    eng = graph.CallGraph(graphed=False)
    first = eng.run(_inputs(seed=0), _affine)
    second = eng.run(_inputs(seed=1), _affine)  # the static outputs now hold run 2
    assert _equal(first, _affine(_inputs(seed=0)))
    assert _equal(second, _affine(_inputs(seed=1)))


def test_routes():
    assert graph.route("cpu") == graph.CPU_EAGER
    assert graph.route("cpu", graph=BODY) == graph.BODY_ROUTE
    assert graph.route("cuda", graph=False) == graph.ASKED_EAGER
    assert graph.route("cuda") == graph.GRAPHED
    # serve keeps the eager texts itself (serving from artifacts imports
    # nothing of train): they are graph.route's.
    assert serve._graph_engine(torch.device("cpu"), None) == (graph.CPU_EAGER, None)
    assert serve._graph_engine(torch.device("cpu"), False) == (graph.ASKED_EAGER, None)
    route, eng = serve._graph_engine(torch.device("cpu"), BODY)
    assert route == graph.BODY_ROUTE and isinstance(eng, graph.CallGraph)
    assert graph.engines(None)("cpu") is None and graph.engines(False)("cuda") is None
    with pytest.raises(ValueError, match="unknown graph"):
        graph.engines("replay")


# ------------------------------------------------------------ evaluation


EVAL_CASES = {
    "kernel-eps": dict(fused_combine=True, kernel_rng=True),
    "weighted": {},
    "sampled": dict(recon_mode="sampled"),
    "smm": dict(dof=4.0),
    "full-head": dict(encoder_head="full"),
    "bernoulli": dict(likelihood="bernoulli", fused_combine=True, fused_mlp_decoder=True),
}


def _eval_setup(case, n=40, d_in=3):
    sw = EVAL_CASES[case]
    config = SvaeConfig(latent_dim=2, num_components=4, num_samples=2, num_total=n, **sw)
    prior = gmm.make_prior(4, 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), d_in, config, prior,
                                 (8, 8), (8, 8))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d_in)) if sw.get("likelihood") != "bernoulli" else (
        rng.random((n, d_in)) < 0.4)
    return config, prior, state, torch.tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_body_route_equals_the_eager_call(case):
    """Three calls with the state and the step changing between them, each
    through a fresh generator (the callers' pattern), a seed and injected ε."""
    config, prior, state, x = _eval_setup(case)
    routes = {g: svae_step.make_eval_fn(config, prior, graph=g) for g in (False, BODY)}
    eps = torch.randn((2, 40, 4, 2), generator=torch.Generator().manual_seed(9))
    for call in range(3):
        state = state._replace(step=state.step + 7, pgm_nat=type(state.pgm_nat)(
            state.pgm_nat.dir_nat * 1.01, state.pgm_nat.niw_nat))
        kwargs = [dict(generator=True), dict(seed=3)]
        if config.recon_mode == "weighted":
            kwargs.append(dict(eps=eps))
        for kw in kwargs:
            got = {}
            for g, ev in routes.items():
                torch.manual_seed(11)  # a seed without the kernel's ε draws from here
                k = dict(kw, generator=torch.Generator().manual_seed(5)) \
                    if "generator" in kw else kw
                got[g] = ev(state, x, **k)
            assert set(got[BODY]) == {"elbo_per_point", "recon_per_point",
                                      "local_kl_per_point", "global_kl"}
            assert _equal(got[False], got[BODY]), (case, call, list(kw))
    # One capture for drawn and injected ε (the same call on an ε input), one
    # more for the in-kernel ε's device word.
    eng = routes[BODY].engine(x.device)
    assert len(eng.calls) == (2 if svae_step.kernel_draws_eps(config) else 1)
    assert routes[BODY].route("cpu") == graph.BODY_ROUTE
    assert routes[False].route("cuda") == graph.ASKED_EAGER
    assert svae_step.make_eval_fn(config, prior).route("cpu") == graph.CPU_EAGER


def test_eval_draws_are_the_forwards():
    """``eval_draws`` draws what the forward draws from one generator: the
    weighted estimator's ε and the sampled one's Gumbel, then ε."""
    config = SvaeConfig(latent_dim=2, num_components=4, num_samples=3, num_total=10)
    got = svae_step.eval_draws(config, 10, torch.Generator().manual_seed(2), "cpu",
                               torch.float32)
    want = torch.randn((3, 10, 4, 2), generator=torch.Generator().manual_seed(2))
    assert set(got) == {"eps"} and torch.equal(got["eps"], want)
    g = torch.Generator().manual_seed(2)
    u = torch.rand((3, 10, 4), generator=g)
    e = torch.randn((3, 10, 2), generator=g)
    got = svae_step.eval_draws(config._replace(recon_mode="sampled"), 10,
                               torch.Generator().manual_seed(2), "cpu", torch.float32)
    gumbel, eps = got["sampled_draws"]
    assert torch.equal(gumbel, -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny))))
    assert torch.equal(eps, e)
    assert svae_step.kernel_draws_eps(config._replace(fused_combine=True, kernel_rng=True))
    for sw in (dict(dof=4.0), dict(encoder_head="full"), dict(jitter=1e-4),
               dict(recon_mode="sampled"), dict(kernel_rng=False)):
        assert not svae_step.kernel_draws_eps(
            config._replace(**{"fused_combine": True, "kernel_rng": True, **sw})), sw


class _Eps:
    """svax.models.svae or svae_smm as the JAX ``make_eval_fn``'s model, its
    noise injected."""

    def __init__(self, module, eps):
        self.module, self.eps = module, eps

    def forward(self, nn, nat, prior, x, key, config):
        return self.module.forward(nn, nat, prior, x, key, config, eps=self.eps)


@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_graphed_eval_matches_the_jax_eval_fn(dof):
    n, k, s = 48, 4, 2
    x = jnp.asarray(jmake_pinwheel(num_classes=3, num_per_class=n // 3, seed=0)[:n],
                    jnp.float64)
    jconfig = JConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n,
                      nn_precision=HIGHEST, dof=dof)
    jprior = jgmm.make_prior(k, 2, kappa=0.05, dtype=jnp.float64)
    jstate = jstep.init_state(jax.random.PRNGKey(0), 2, jconfig, jprior, optax.adam(1e-3),
                              (12, 12), (12, 12), data=x, dtype=jnp.float64)
    eps = np.random.default_rng(1).standard_normal((s, n, k, 2))
    model = _Eps(jsvae_smm if dof > 0 else jsvae, jnp.asarray(eps))
    want = jstep.make_eval_fn(jconfig, jprior, model=model)(jstate, x, jax.random.PRNGKey(0))
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), dtype=torch.float64)
    prior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jprior), dtype=torch.float64)
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n, dof=dof)
    xt = torch.tensor(np.asarray(x))
    got = svae_step.make_eval_fn(config, prior, graph=BODY)(state, xt, eps=torch.tensor(eps))
    eager = svae_step.make_eval_fn(config, prior, graph=False)(state, xt,
                                                               eps=torch.tensor(eps))
    assert _equal(got, eager)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=1e-9,
                                   err_msg=name)


def test_train_svae_prints_the_evaluation_route():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_svae.main(["--device", "cpu", "--steps", "2", "--scan-chunk", "2",
                         "--iw-samples", "0", "-K", "4", "--encoder-hidden", "8", "8",
                         "--decoder-hidden", "8", "8"])
    first = json.loads(buf.getvalue().splitlines()[0])
    assert first["eval_graph"] == graph.CPU_EAGER


# --------------------------------------------------------------- serving


def _server_pair(dof: float, buckets=(32, 512)):
    spec = serve.ModelSpec(input_dim=5, latent_dim=2, num_components=4, encoder_hidden=(16,),
                           decoder_hidden=(16,), num_samples=2, num_total=100, dof=dof)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 5, spec.to_config(),
                                 spec.make_prior(), spec.encoder_hidden, spec.decoder_hidden)
    return {g: serve.SvaeServer(state.nn_params, state.pgm_nat, spec, buckets=buckets,
                                device="cpu", graph=g) for g in (False, BODY)}


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 5)).astype(np.float32),
            rng.random((n, 5)) > 0.3)


def _live_answers(srv, x, mask):
    return [srv.encode(x), srv.reconstruct(x), srv.cluster(x),
            srv.score(x, seed=2, num_samples=7), srv.impute(x, mask, num_iters=3),
            srv.impute(x, mask, num_iters=2, mode="map")]


@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_live_endpoints_body_route_equals_eager(dof):
    """Requests at bucket 32 (20 rows) and over the top bucket (600 rows:
    two pieces at bucket 512), every endpoint."""
    servers = _server_pair(dof)
    x, mask = _requests(600)
    for n in (20, 600):
        got = {g: _live_answers(srv, x[:n], mask[:n]) for g, srv in servers.items()}
        assert _host_equal(got[False], got[BODY]), n
    body = servers[BODY]
    assert body.route == graph.BODY_ROUTE and servers[False].route == graph.ASKED_EAGER
    # (endpoint, bucket, static arguments): encode, reconstruct and score at
    # 32 and 512, impute at both buckets in two (rounds, mode) settings.
    assert len(body.graphs.calls) == 3 * 2 + 2 * 2


def test_two_pieces_at_one_bucket_return_each_pieces_rows():
    """64 rows over a top bucket of 32 replay one graph twice: the answer is
    the two 32-row requests' answers, so each replay's outputs were cloned
    before the next overwrote them."""
    srv = _server_pair(0.0, buckets=(8, 32))[BODY]
    x, mask = _requests(64, seed=3)
    calls = {"encode": lambda a, m: srv.encode(a),
             "reconstruct": lambda a, m: srv.reconstruct(a),
             "impute": lambda a, m: srv.impute(a, m, num_iters=2)}
    for name, call in calls.items():
        whole, head, tail = call(x, mask), call(x[:32], mask[:32]), call(x[32:], mask[32:])
        pairs = ([(whole[k], head[k], tail[k]) for k in whole] if isinstance(whole, dict)
                 else [(whole, head, tail)])
        for w, h, t in pairs:
            assert np.array_equal(w, np.concatenate([h, t])), name
            assert not np.array_equal(h, t), name
    assert len(srv.graphs.calls) == 3


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = {}
    for dof in (0.0, 4.0):
        path = tmp_path_factory.mktemp(f"exported_{dof}")
        serve.export_serving(_server_pair(dof)[False], path, buckets=(32, 512),
                             score_samples=7, impute_iters=3)
        out[dof] = path
    return out


@pytest.mark.parametrize("dof", [0.0, 4.0])
def test_exported_endpoints_body_route_equals_eager(dof, exported):
    servers = {g: serve.load_exported(exported[dof], graph=g) for g in (False, BODY)}
    x, mask = _requests(600, seed=4)
    for n in (20, 600):  # bucket 32; two pieces at bucket 512
        got = {g: [srv.encode(x[:n]), srv.reconstruct(x[:n]), srv.score(x[:n], seed=2),
                   srv.impute(x[:n], mask[:n])] for g, srv in servers.items()}
        assert _host_equal(got[False], got[BODY]), n
    assert servers[BODY].route == graph.BODY_ROUTE
    assert len(servers[BODY].graphs.calls) == 4 * 2
    assert serve.load_exported(exported[dof]).route == graph.CPU_EAGER


# ---------------------------------------------------------- online rules


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _online_setup(k=6, n=200, hidden=(16, 16)):
    """A float64 JAX state at random weights (tests/test_torch_demos.py's
    recipe), its conversion, and a 3-step contaminated stream."""
    x = jnp.asarray(jmake_pinwheel(num_per_class=n // 5, seed=0), jnp.float64)
    config = JConfig(latent_dim=2, num_components=k, num_samples=1, num_total=n)
    prior = _f64(jgmm.make_prior(k, 2, kappa=0.05))
    state = _f64(jstep.init_state(jax.random.PRNGKey(0), 2, config, prior,
                                  optax.adam(1e-3), hidden, hidden, data=x))
    port = convert.state_from_numpy(jax.tree.map(np.asarray, state), dtype=torch.float64)
    pprior = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, prior), dtype=torch.float64)
    _, contam, _ = latent_contamination_demo.make_streams(0, 3, 40, 0.25, 30.0)
    return state, prior, port, pprior, contam.astype(np.float64)


def _reference_online(rule, state, prior, stream, rho, scale, dof, iters):
    """experiments/latent_contamination_demo.py:150-182's rules under
    ``jax.lax.scan``."""
    nn = state.nn_params

    def body(nat, xb):
        pot_h, pot_p = jnets.encoder_apply(nn["encoder"], xb, jnp.tanh, HIGHEST)
        exp = jgmm.expected_params(nat)
        if rule == "gmm":
            post = jsvae.sin_combine(pot_h, pot_p, exp, jitter=0.0)
            ezz = post.cov + post.mean[..., :, None] * post.mean[..., None, :]
            stats = jgmm.suff_stats_from_moments(jnp.exp(post.log_resp), post.mean, ezz,
                                                 scale)
            return jnatgrad.cvi_update(nat, prior, jgmm.stats_to_nat(stats), rho), jnp.ones(())
        post, _ = jsvae_smm.smm_combine(pot_h, pot_p, exp, dof, iters, 0.0)
        stats = jsvae_smm.suff_stats_latent(post, scale)
        nat = jnatgrad.cvi_update(nat, prior, jsmm.stats_to_nat(stats), rho)
        return nat, jnp.sum(jnp.exp(post.log_resp) * post.e_u, axis=-1)

    return jax.jit(lambda nat, s: jax.lax.scan(body, nat, s))(state.pgm_nat,
                                                               jnp.asarray(stream))


@pytest.mark.parametrize("rule", ["gmm", "smm"])
def test_online_body_route_equals_the_loop_and_the_reference(rule):
    state, prior, port, pprior, stream = _online_setup()
    rho, scale, dof, iters = 0.05, 200.0 / 40, 4.0, 2
    cfg = SvaeConfig(latent_dim=2, num_components=6, num_samples=4, num_total=200)
    common = dict(nn=port.nn_params, prior=pprior, config=cfg, rho=rho, scale=scale)
    fn = (partial(latent_contamination_demo.gmm_online, **common) if rule == "gmm" else
          partial(latent_contamination_demo.smm_online, **common, dof=dof, smm_iters=iters))
    s = torch.tensor(stream)
    eager = latent_contamination_demo.run_online(fn, port.pgm_nat, s)
    eng = graph.ChunkGraph(graphed=False)
    body = latent_contamination_demo.run_online(fn, port.pgm_nat, s, eng)
    assert _equal(eager, body)
    again = latent_contamination_demo.run_online(fn, port.pgm_nat, s.flip(0), eng)
    assert _equal(again, latent_contamination_demo.run_online(fn, port.pgm_nat, s.flip(0)))
    assert body[1].shape == ((3,) if rule == "gmm" else (3, 40))
    want_nat, want_aux = _reference_online(rule, state, prior, stream, rho, scale, dof, iters)
    for a, b in zip([body[0].dir_nat, *body[0].niw_nat],
                    [want_nat.dir_nat, *want_nat.niw_nat]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(body[1].numpy(), np.asarray(want_aux), rtol=1e-5, atol=1e-5)


def test_latent_demo_prints_the_online_route(capsys):
    out = latent_contamination_demo.main(
        ["--device", "cpu", "--pretrain-steps", "10", "--scan-chunk", "10",
         "--online-steps", "3", "--batch", "40", "--iw-samples", "5", "--json", ""])
    assert out["online_graph"] == graph.CPU_EAGER
    assert f"online route: {graph.CPU_EAGER}" in capsys.readouterr().out
