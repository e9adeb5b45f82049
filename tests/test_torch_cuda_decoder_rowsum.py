"""The row-sum CUDA kernels on the card (``ops/decoder.py``,
``csrc/decoder.cu``): forward and recompute backward against their plain
version in both modes at ragged and multi-block shapes (M not a multiple
of the 64-row tile, D = 33 and 784), bit-equal reruns, the launch counters,
and the wrapper raising (not falling back) outside its shape class.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_decoder_rowsum.py -m requires_cuda --noconftest
"""

import pytest
import torch

from svax_torch.measure_mnist import (rowsum_errors, rowsum_failures, rowsum_grads,
                                      rowsum_inputs)
from svax_torch.ops import decoder

torch.set_num_threads(1)
pytestmark = pytest.mark.requires_cuda

# (M, Dh, D): ragged everywhere; several row tiles and D chunks; the mnist
# decoder's rows (S·N·K = 2,560); a wide Dh at the kernels' limit.
SHAPES = [(37, 20, 33), (300, 70, 150), (1000, 200, 784), (2560, 200, 784), (130, 512, 33)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(dev, shape, precision):
    before = (decoder.launches, decoder.backward_launches)
    errs = rowsum_errors(*rowsum_inputs(dev, *shape), precision)
    torch.cuda.synchronize()
    assert (decoder.launches, decoder.backward_launches) == (before[0] + 1, before[1] + 1)
    assert not rowsum_failures(errs, precision), errs


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_reruns_are_bit_equal(dev, precision):
    args = rowsum_inputs(dev, 3000, 200, 784, seed=2)
    runs = [rowsum_grads(decoder.rowsum_logsig_neg, *args, precision) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_high_is_default_and_leading_axes_flatten(dev):
    h, w, b, _ = rowsum_inputs(dev, 2 * 3 * 5, 24, 40, seed=3)
    s = decoder.rowsum_logsig_neg(h, w, b, "default")
    assert torch.equal(decoder.rowsum_logsig_neg(h, w, b, "high"), s)
    assert torch.equal(decoder.rowsum_logsig_neg(h.reshape(2, 3, 5, 24), w, b, "default"),
                       s.reshape(2, 3, 5))


def test_wrapper_raises_outside_the_shape_class(dev):
    before = (decoder.launches, decoder.backward_launches)
    h, w, b, _ = rowsum_inputs(dev, 10, 16, 24)
    with pytest.raises(ValueError, match="float32"):
        decoder.rowsum_logsig_neg(h.double(), w, b)
    with pytest.raises(ValueError, match="do not fit"):
        decoder.rowsum_logsig_neg(h, w[:15], b)
    with pytest.raises(ValueError, match="Dh <= 512"):
        decoder.rowsum_logsig_neg(*rowsum_inputs(dev, 10, 513, 24)[:3])
    with pytest.raises(ValueError, match="precision"):
        decoder.rowsum_logsig_neg(h, w, b, "bf16")
    assert (decoder.launches, decoder.backward_launches) == before


def test_cpu_tensors_run_the_plain_version_without_launching(dev):
    h, w, b, _ = rowsum_inputs(torch.device("cpu"), 12, 16, 24)
    before = (decoder.launches, decoder.backward_launches)
    s = decoder.rowsum_logsig_neg(h, w, b)
    assert torch.equal(s, decoder.rowsum_logsig_neg_plain(h, w, b))
    assert (decoder.launches, decoder.backward_launches) == before
