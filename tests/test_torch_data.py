"""The port's pinwheel copy is bit-equal to svax.data.pinwheel, and the
port's import graph never reaches JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svax.data import pinwheel as ref
from svax_torch.data import pinwheel as port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_pinwheel_bit_equal(seed):
    a, la = port.make_pinwheel_data(seed=seed, return_labels=True)
    b, lb = ref.make_pinwheel_data(seed=seed, return_labels=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(
        port.make_pinwheel_data(num_classes=3, num_per_class=24, rate=0.4, seed=seed),
        ref.make_pinwheel_data(num_classes=3, num_per_class=24, rate=0.4, seed=seed),
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_load_pinwheel_bit_equal(seed):
    for got, want in zip(port.load_pinwheel(seed=seed, return_labels=True),
                         ref.load_pinwheel(seed=seed, return_labels=True)):
        np.testing.assert_array_equal(got, want)
    train, test = port.load_pinwheel(seed=seed)
    assert train.shape == (400, 2) and test.shape == (100, 2)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import svax_torch, svax_torch.train_svae, svax_torch.ops.tinystep\n"
        "import svax_torch.convert, svax_torch.train.loop\n"
        "import svax_torch.train_gmm, svax_torch.train_smm, svax_torch.ops.mixstep\n"
        "import svax_torch.ops.estep, svax_torch.models.evaluation, svax_torch.pgm.init\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'svax' or m.startswith('svax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
