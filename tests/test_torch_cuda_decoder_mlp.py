"""The fused MLP-decoder CUDA kernels on the card: forward and recompute
backward against their plain version at small, ragged, multi-block, shard
and bigk shapes, bit-equal reruns, the launch counters, the forward
block's shared memory against its Python mirror, and the wrapper raising
(not falling back) outside its shape class.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_decoder_mlp.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from svax_torch.measure_mnist import DECODER_TOL, decoder_errors, decoder_inputs
from svax_torch.ops import decoder_mlp

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# (S, N, K, d, H1, H2, D): small; ragged (nothing a multiple of 8 or 16);
# S = 2 with many blocks of points; the mnist and bigk shapes; hidden 256
# (the wider width class). The engine's edges: rows one past a 64-row tile
# and D not a multiple of the 64-column slab or chunk; fewer points (3)
# than mlp_tail's blocks, with d = 1; both hidden widths at the cap with
# D = 784; one width in each class (112 and 240 padded). The forward's
# 64-row blocks: one rank's bigk shard on a 1x2 comp mesh (K = 50) and one
# on a 2x1 data mesh (N = 512), and rows (16,900) not a multiple of 64, with D
# not a multiple of the 64-column slab.
SHAPES = [(2, 40, 5, 3, 16, 16, 24), (1, 37, 7, 3, 24, 40, 50), (2, 300, 5, 3, 16, 16, 24),
          (1, 256, 10, 8, 200, 200, 784), (1, 1024, 100, 10, 200, 200, 784),
          (2, 150, 3, 16, 256, 256, 40), (1, 13, 5, 4, 200, 200, 100),
          (1, 3, 2, 1, 200, 200, 784), (1, 40, 5, 10, 256, 256, 784),
          (1, 50, 6, 7, 100, 240, 300), (1, 1024, 50, 10, 200, 200, 784),
          (1, 512, 100, 10, 200, 200, 784), (1, 4225, 4, 10, 200, 200, 777)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(dev, shape):
    before = (decoder_mlp.launches, decoder_mlp.backward_launches)
    errs = decoder_errors(*decoder_inputs(dev, *shape))
    torch.cuda.synchronize()
    assert (decoder_mlp.launches, decoder_mlp.backward_launches) == (before[0] + 1,
                                                                    before[1] + 1)
    assert errs["ll"] <= DECODER_TOL["ll"], errs
    assert errs["ll share > 1e-5"] < DECODER_TOL["ll share > 1e-5"], errs
    assert errs["dz max"] < DECODER_TOL["dz max"], errs
    assert errs["dz share > 1e-5"] < DECODER_TOL["dz share > 1e-5"], errs
    for name in ("w1", "b1", "w2", "b2", "w3", "b3", "y", "c"):
        assert errs[name] < DECODER_TOL["grad"], (name, errs)
    assert errs["finite"], errs


def test_reruns_are_bit_equal(dev):
    params, z, x, dll = decoder_inputs(dev, 1, 1024, 100, 10, 200, 200, 784, seed=2)

    def run():
        leaves = [z.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for ly in params for t in (ly["w"], ly["b"])]
        ps = [{"w": leaves[1 + 2 * i], "b": leaves[2 + 2 * i]} for i in range(3)]
        ll = decoder_mlp.bernoulli_mlp_loglik_fused(ps, leaves[0], x)
        return [ll, *torch.autograd.grad((ll * dll).sum(), leaves)]

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_forward_smem_matches_the_mirror(dev):
    """The C entry's shared memory of the forward block equals the Python
    mirror the CPU tests hold within the card's limit."""
    from svax_torch.ops import _build

    lib = _build.load()
    for s, n, k, h1, h2, dd in ((1, 256, 10, 200, 200, 784), (1, 1024, 100, 200, 200, 784),
                                (1, 40, 5, 256, 256, 784), (1, 50, 6, 100, 240, 300),
                                (2, 40, 5, 16, 16, 24)):
        assert lib.decoder_mlp_forward_smem_bytes(n, k, s, 8, h1, h2, dd) == \
            decoder_mlp.forward_smem_bytes(h1, h2, s * n * k), (s, n, k, h1, h2, dd)


def test_wrapper_raises_outside_the_shape_class(dev):
    before = (decoder_mlp.launches, decoder_mlp.backward_launches)
    params, z, x, _ = decoder_inputs(dev, 1, 8, 3, 17, 16, 16, 24)
    with pytest.raises(ValueError, match="latent d = 17"):
        decoder_mlp.bernoulli_mlp_loglik_fused(params, z, x)
    params, z, x, _ = decoder_inputs(dev, 1, 8, 3, 4, 16, 300, 24)
    with pytest.raises(ValueError, match="hidden widths"):
        decoder_mlp.bernoulli_mlp_loglik_fused(params, z, x)
    params, z, x, _ = decoder_inputs(dev, 1, 8, 3, 4, 16, 16, 24)
    with pytest.raises(ValueError, match="2 hidden layers"):
        decoder_mlp.bernoulli_mlp_loglik_fused(params + params[-1:], z, x)
    with pytest.raises(ValueError, match="float32"):
        decoder_mlp.bernoulli_mlp_loglik_fused(params, z.double(), x)
    with pytest.raises(ValueError, match=r"must be \(N, D\)"):
        decoder_mlp.bernoulli_mlp_loglik_fused(params, z, x[:, :5])
    assert (decoder_mlp.launches, decoder_mlp.backward_launches) == before


def test_cpu_tensors_run_the_plain_version_without_launching(dev):
    params, z, x, _ = decoder_inputs(torch.device("cpu"), 1, 12, 4, 3, 16, 16, 24)
    before = (decoder_mlp.launches, decoder_mlp.backward_launches)
    ll = decoder_mlp.bernoulli_mlp_loglik_fused(params, z, x)
    assert torch.equal(ll, decoder_mlp.bernoulli_mlp_loglik_plain(params, z, x))
    assert (decoder_mlp.launches, decoder_mlp.backward_launches) == before
    assert np.isfinite(ll.numpy()).all()
