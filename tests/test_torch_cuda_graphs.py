"""The graphed runners on the card: a chunk replayed as a CUDA graph of
one captured train step against the eager loop, bit for bit, at the
configs' full widths; recapture, a shorter last chunk, resume across a
chunk boundary, the launch counters, and a capture that fails raising.

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
