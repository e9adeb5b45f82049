"""The comparison's models on the card: the plain VAE's ELBO and gradients
and the Bernoulli-mixture step on ``cuda`` against ``cpu`` (float32, one
set of inputs and noise), and a cut pinwheel ``compare --engine kernel``
that runs the SVAE leg on tinystep's f32 mode.

Every test needs a CUDA device and skips without one. The file imports no
JAX:

    python -m pytest tests/test_torch_cuda_compare.py -m requires_cuda --noconftest
"""

import json
import math

import numpy as np
import pytest
import torch

from svax_torch import compare
from svax_torch.data import load_dataset
from svax_torch.models import bmm_baseline, vae
from svax_torch.ops import tinystep
from svax_torch.pgm import bmm
from svax_torch.utils.tree import flatten

pytestmark = pytest.mark.requires_cuda
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device):
    return {side: [{k: t.to(device) for k, t in ly.items()} for ly in layers]
            for side, layers in tree.items()}


@pytest.mark.parametrize("ds", ["auto", "mnist"])
def test_vae_elbo_and_gradients_cuda_vs_cpu(dev, ds):
    train, _, meta = load_dataset(ds, seed=0)
    x = torch.tensor(train[:256], dtype=torch.float32)
    config = vae.VaeConfig(latent_dim=4, num_samples=2, likelihood=meta["likelihood"])
    params = vae.init_params(torch.Generator().manual_seed(0), x.shape[1], config,
                             (100, 100), (100, 100))
    eps = torch.randn((2, x.shape[0], 4), generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", dev):
        p = {side: [{k: t.to(device).requires_grad_(True) for k, t in ly.items()}
                    for ly in layers] for side, layers in params.items()}
        val, parts = vae.elbo(p, x.to(device), None, config, eps=eps.to(device))
        grads = torch.autograd.grad(val, [t for _, t in flatten(p)])
        out[str(device)] = (val, parts, grads)
    (v_c, p_c, g_c), (v_g, p_g, g_g) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(v_g.cpu(), v_c, **F32)
    for name in ("recon", "kl"):
        torch.testing.assert_close(p_g[name].cpu(), p_c[name], **F32)
    for a, b in zip(g_g, g_c):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale + 1e-6


def test_bmm_step_cuda_vs_cpu(dev):
    train, test, _ = load_dataset("mnist", seed=0)
    x = torch.tensor(train, dtype=torch.float32)
    rows = torch.tensor(compare.REFERENCE_INIT_ROWS["mnist"])
    states, mets = {}, {}
    for device in ("cpu", dev):
        prior = bmm.make_prior(10, x.shape[1], device=device)
        st = bmm_baseline.init_state(None, prior, x.to(device), rows=rows)
        step = bmm_baseline.make_train_step(prior, 1.0, x.shape[0])
        for _ in range(3):
            st, m = step(st, x.to(device))
        states[str(device)], mets[str(device)] = st, m
    c, g = states["cpu"], states[str(dev)]
    torch.testing.assert_close(g.nat.dir_nat.cpu(), c.nat.dir_nat, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(g.nat.beta_nat.cpu(), c.nat.beta_nat, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(mets[str(dev)]["elbo"].cpu(), mets["cpu"]["elbo"], rtol=1e-5,
                               atol=0.0)


def test_cut_pinwheel_compare_runs_tinystep(dev, tmp_path):
    out = tmp_path / "cmp.json"
    tinystep.launches = tinystep.launches_bf16 = 0
    res = compare.main(["--quick", "--engine", "kernel", "--datasets", "pinwheel",
                        "--out", str(out)])
    assert tinystep.launches >= 2 and tinystep.launches_bf16 == 0
    row = json.loads(out.read_text())["pinwheel"]
    assert row["budget"]["svae_engine"] == "kernel"
    assert (row["budget"]["svae_kernel"], row["budget"]["svae_kernel_mode"]) == ("tinystep",
                                                                                 "f32")
    assert all(math.isfinite(row[k]["iw_best"]) for k in ("svae", "vae"))
    assert math.isfinite(row["gmm"]["exact_predictive"])
    assert [leg["engine"] for leg in res["pinwheel"]["legs"]] == [
        "kernel (tinystep, f32)", "step", "step"]
    assert np.isfinite([leg["seconds"] for leg in res["pinwheel"]["legs"]]).all()
