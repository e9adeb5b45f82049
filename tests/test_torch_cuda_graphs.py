"""The graphed runners on the card: a chunk replayed as a CUDA graph of
one captured train step against the eager loop, bit for bit, at the
configs' full widths; recapture, a shorter last chunk, resume across a
chunk boundary, the launch counters, and a capture that fails raising.
The one-call graphs (``graph.CallGraph``) likewise: the held-out
evaluation at mnist-svae and bigk-dp width on the kernel and plain
engines, every served endpoint live and exported, and the latent demo's
online rules, each against its eager route bit for bit.

Every test needs a CUDA device and skips without one. The file imports no
JAX:

    python -m pytest tests/test_torch_cuda_graphs.py -m requires_cuda --noconftest
"""

import pytest
import torch

from svax_torch import measure_graphs
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import combine
from svax_torch.pgm import gmm
from svax_torch.train import graph, loop, svae_step
from svax_torch.train.checkpoint import Checkpointer

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def test_torch_registers_generators_with_a_graph(dev):
    """The runners register the step's generator with the graph, so that a
    replay draws what the eager loop draws (torch ≥ 2.4's CUDAGraph)."""
    assert hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def test_table_division_rounds_as_the_eager_division(dev):
    """On CUDA PyTorch divides by a Python scalar as a product by its
    reciprocal taken in double; ``graph.divide`` reads that reciprocal's
    row, so Adam's bias corrections round as the eager step's."""
    x = torch.randn(100_000, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    start = 3
    tables = graph.Tables(8, dev)
    tables.load({0: start}, 8)
    fn = lambda c: 1.0 - svae_step.B2**(c + 1)  # noqa: E731
    for t in range(8):
        tables.ctr.fill_(t)
        graph._active = tables
        try:
            got = graph.divide([x], "adam_bias2", fn, graph.Tick(start, 0), x)[0]
        finally:
            graph._active = None
        assert torch.equal(got, torch._foreach_div([x], fn(start + t))[0]), t


@pytest.mark.parametrize("path", ["mnist-svae", "bigk-dp", "full-head", "vae", "gmm-fused"])
def test_graphed_equals_eager_over_200_steps(dev, path):
    """200 steps in a chunk of 150 and a shorter one of 50 (the same graph
    replayed, one capture): states and every metric bit-equal."""
    got = measure_graphs.equal_routes(dev, path, (150, 50))
    assert got["equal"], path
    assert got["captures"] == 1


def _small(dev, n: int, batch: int = 0, **kw):
    config = SvaeConfig(latent_dim=2, num_components=4, num_samples=2, num_total=n,
                        fused_combine=True, kernel_rng=True)
    prior = gmm.make_prior(4, 2, kappa=0.05, device=dev)
    state = svae_step.init_state(torch.Generator(device=dev).manual_seed(0), 3, config,
                                 prior, (16, 16), (16, 16))
    return config, prior, state


def test_recaptures_when_x_or_the_batch_changes(dev):
    xa = torch.randn(64, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    xb = torch.randn(48, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    config, prior, state = _small(dev, 64)
    runs = {g: loop.make_step_runner(config, prior, lr=1e-2, rho=0.2, graph=g)
            for g in (False, None)}
    out = {}
    for g, run in runs.items():
        st = state
        st, ma = run(st, xa, 7, seed=3)
        st, mb = run(st, xb, 5, seed=3)  # another x, a full batch of another size
        st, mc = run(st, xa, 9, seed=3)
        out[g] = (st, [ma, mb, mc])
    assert measure_graphs.same(out[False], out[None])
    assert runs[None].engine(dev).captures == 3


def test_resume_across_a_chunk_boundary_is_bit_exact(dev, tmp_path):
    """A chunk, a checkpoint round trip and a fresh runner: the same as one
    runner's two chunks."""
    x = torch.randn(200, 3, generator=torch.Generator().manual_seed(4)).to(dev)
    config, prior, state = _small(dev, 200)
    kw = dict(lr=1e-2, rho=0.2, rho_decay=0.01, batch_size=32, aug_noise=0.1)
    run = loop.make_step_runner(config, prior, **kw)
    whole, _ = run(state, x, 30, seed=5)
    whole, mw = run(whole, x, 20, seed=5)
    cut, _ = run(state, x, 30, seed=5)
    Checkpointer(str(tmp_path)).save(cut.step, cut)
    restored, _, start = Checkpointer(str(tmp_path)).restore_or(state)
    assert start == 30 and restored.step == 30
    resumed, mr = loop.make_step_runner(config, prior, **kw)(restored, x, 20, seed=5)
    assert measure_graphs.same((whole, mw), (resumed, mr))


def test_combine_counters_equal_under_both_routes(dev):
    counts = {}
    for g in (False, None):
        chunk, state, _ = measure_graphs.setup(dev, "mnist-svae", g)
        combine.launches = combine.backward_launches = combine.lean_backward_launches = 0
        combine.backward_paths.clear()
        chunk(state, 30)
        chunk(state, 10)
        counts[g] = (combine.launches, combine.backward_launches,
                     combine.lean_backward_launches, dict(combine.backward_paths))
    assert counts[False] == counts[None] == (40, 40, 40, {"dz+dlr+dlocal": 40})


def test_a_capture_that_fails_raises(dev):
    """A step that reads a value on the host cannot be captured: the runner
    raises, and never falls back to the eager loop."""
    from svax_torch.models import gmm_baseline

    x = torch.randn(64, 2, generator=torch.Generator().manual_seed(6)).to(dev)
    prior = gmm.make_prior(3, 2, device=dev)
    state = gmm_baseline.init_state(torch.Generator(device=dev).manual_seed(0), prior, x)
    step = gmm_baseline.make_train_step(prior, 0.5, num_total=64)

    def syncing(st, xb):
        if float(xb.sum()) != float(xb.sum()):  # a host read: no capture can hold it
            raise AssertionError("NaN data")
        return step(st, xb)

    run = loop.make_batch_runner(syncing)
    with pytest.raises(Exception):
        run(state, x, 4)
    assert loop.make_batch_runner(syncing, graph=False)(state, x, 4)[0].step == 4


# The kernel launch counters each evaluation path must show inside its
# graph, once a call (the plain engine's evaluation launches none).
EVAL_LAUNCHES = {"mnist-svae": ("combine.launches",),
                 "bigk-dp": ("combine.launches", "decoder_mlp.launches"),
                 "bigk-f32": ("combine.launches", "decoder.launches", "decoder.bf16_launches"),
                 "mnist-plain": ()}


@pytest.mark.parametrize("path", measure_graphs.EVAL_PATHS)
def test_graphed_eval_equals_eager(dev, path):
    """Three calls on the test set with the state (tensors and step) moved
    10 graphed steps between calls, through the entry's noise (the
    combine's in-kernel ε keyed {seed, step}, or ε from a fresh generator
    each call): the four terms bit-equal, one capture, the launch counts
    of each call equal to the eager call's."""
    got = measure_graphs.eval_routes(dev, path, calls=3)
    assert got["route"] == graph.GRAPHED
    assert got["equal"] and got["counts_equal"], got
    assert got["captures"] == 1
    launched = {k for k, v in got["launches"].items() if v}
    assert launched == set(EVAL_LAUNCHES[path]), got["launches"]
    assert all(got["launches"][k] == 3 for k in launched), got["launches"]


def test_served_endpoints_graphed_equal_eager(dev, tmp_path):
    """Every endpoint, live and exported, at buckets 32, 512 and 8192 and a
    request of two 8192-row pieces (one graph replayed twice)."""
    got = measure_graphs.serve_routes(dev, buckets=(32, 512, 8192), repeats=0,
                                      work=tmp_path)
    assert len(got["equal"]) == 2 * 4 * 4
    assert all(got["equal"].values()), [k for k, v in got["equal"].items() if not v]
    for tier in ("live", "exported"):
        assert got["graphs"][tier]["route"] == graph.GRAPHED
        assert got["graphs"][tier]["captures"] == 4 * 3


def test_served_student_t_endpoints_graphed_equal_eager(dev):
    """The Student-t prior's endpoints, live, at buckets 32 and 512 and a
    request of two 512-row pieces (its exported programs are held to the
    live bodies on the CPU: at d = 8 its unrolled solves take minutes to
    trace)."""
    got = measure_graphs.serve_routes(dev, buckets=(32, 512), repeats=0, dof=4.0,
                                      exported=False)
    assert len(got["equal"]) == 3 * 4
    assert all(got["equal"].values()), [k for k, v in got["equal"].items() if not v]
    assert got["graphs"]["live"]["captures"] == 4 * 2


def test_online_rules_graphed_equal_eager(dev):
    """Both online CVI rules over 200 steps: final naturals and the stacked
    E[u] bit-equal to the eager loop, one capture a rule."""
    for rule, got in measure_graphs.online_routes(dev, steps=200).items():
        assert got["equal"], rule
        assert got["captures"] == 1, rule


def test_a_call_capture_that_fails_raises(dev):
    """A call that reads a value on the host cannot be captured: the
    one-call graph raises, and never falls back to the eager call."""
    x = torch.arange(8.0, device=dev)

    def syncing(a):
        if float(a["x"].sum()) != float(a["x"].sum()):  # a host read
            raise AssertionError("NaN data")
        return {"y": a["x"] * 2.0}

    with pytest.raises(Exception):
        graph.CallGraph().run({"x": x}, syncing)
    assert torch.equal(graph.CallGraph(graphed=False).run({"x": x}, syncing)["y"], x * 2.0)
