"""The port's mixstep path against the TPU kernel's own body (float32).

``mixstep.train_chunk`` on CPU tensors (its plain version: T steps of the
GMM or SMM step) against ``svax/ops/mixstep_pallas.train_chunk`` run by
the Pallas interpreter, at tests/test_mixstep_kernel.py's bars (naturals
rtol 3e-4 atol 3e-4; local evidence rtol 2e-4 atol 2e-3), from converted
naturals. Then the unroll contract (U ∈ {1, 2, 4, 8}, dividing T, kernel
engine only — every other request raises), chunk-split bit-equality, the
runner, the gate and the entries' checks. The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda_mixture.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svax.data import make_pinwheel_data
from svax.models import gmm_baseline as jgmm_baseline
from svax.ops import mixstep_pallas as msp
from svax.pgm import gmm as jgmm
from svax_torch import convert, train_gmm, train_smm
from svax_torch.models.gmm_baseline import GmmTrainState
from svax_torch.models.smm_baseline import SmmTrainState
from svax_torch.ops import mixstep
from svax_torch.pgm import gmm
from svax_torch.train import loop

torch.set_num_threads(1)

NAT_TOL = dict(rtol=3e-4, atol=3e-4)
EVID_TOL = dict(rtol=2e-4, atol=2e-3)


def _setup(n, k, seed=0):
    x = np.asarray(make_pinwheel_data(num_classes=5, num_per_class=-(-n // 5),
                                      seed=seed)[:n], np.float32)
    jprior = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jgmm.make_prior(k, 2, kappa=0.05))
    jstate = jgmm_baseline.init_state(jax.random.PRNGKey(seed), jprior, jnp.asarray(x))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    prior = convert.gmm_nat_from_numpy(to_np(jprior))
    state = convert.mixture_state_from_numpy(to_np(jstate))
    return x, jprior, jstate, prior, state


def _assert_nat_close(nat, jnat, **tol):
    got = convert.gmm_nat_to_numpy(nat)
    np.testing.assert_allclose(got["dir_nat"], np.asarray(jnat.dir_nat), **tol)
    for f in ("eta1", "eta2", "eta3", "eta4"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnat.niw_nat, f)),
                                   err_msg=f, **tol)


@pytest.mark.parametrize("case", [
    dict(n=72, k=5, rho=0.3, t=6),                     # the GMM
    dict(n=130, k=10, rho=0.5, t=3, seed=3),           # N not a multiple of 128
    dict(n=72, k=5, rho=0.4, t=4, num_total=144, seed=2),  # num_total scaling
    dict(n=72, k=5, rho=0.3, t=5, dof=4.0, seed=4),    # the SMM
], ids=["gmm", "ragged_n", "num_total", "smm"])
def test_plain_chunk_matches_pallas_interpret(case):
    seed, dof = case.get("seed", 0), case.get("dof", 0.0)
    x, jprior, jstate, prior, state = _setup(case["n"], case["k"], seed)
    if dof > 0.0:
        state = SmmTrainState(nat=state.nat, step=0)
    kw = dict(rho=case["rho"], t_steps=case["t"], num_total=case.get("num_total"),
              dof=dof)
    before = mixstep.launches
    st, mets = mixstep.train_chunk(state, prior, torch.tensor(x), **kw)
    assert mixstep.launches == before  # CPU tensors take the plain version
    jst, jmets = msp.train_chunk(jstate, jprior, jnp.asarray(x), interpret=True, **kw)
    _assert_nat_close(st.nat, jst.nat, **NAT_TOL)
    np.testing.assert_allclose(mets["local_evidence"].numpy(),
                               np.asarray(jmets["local_evidence"]), **EVID_TOL)
    assert st.step == int(jst.step) == case["t"]
    assert type(st) is type(state)


def test_smm_reduces_to_gmm_at_large_dof():
    x, jprior, jstate, prior, state = _setup(64, 4, seed=5)
    kw = dict(rho=0.6, t_steps=2)
    smm_state, _ = mixstep.train_chunk(state, prior, torch.tensor(x), dof=1e4, **kw)
    gmm_state, _ = mixstep.train_chunk(state, prior, torch.tensor(x), **kw)
    jgmm_state, _ = msp.train_chunk(jstate, jprior, jnp.asarray(x), interpret=True, **kw)
    _assert_nat_close(smm_state.nat, jgmm_state.nat, rtol=0.03, atol=0.03)
    _assert_nat_close(gmm_state.nat, jgmm_state.nat, **NAT_TOL)


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_chunk_split_is_bit_equal(unroll):
    """One 8-step chunk against two 4-step chunks (the resume contract),
    and every U against U = 1."""
    x, _, _, prior, state = _setup(72, 5)
    xt = torch.tensor(x)
    kw = dict(rho=0.3, dof=0.0)
    whole, mets = mixstep.train_chunk(state, prior, xt, t_steps=8, unroll=1, **kw)
    half, m1 = mixstep.train_chunk(state, prior, xt, t_steps=4, unroll=1, **kw)
    half, m2 = mixstep.train_chunk(half, prior, xt, t_steps=4, unroll=1, **kw)
    other, _ = mixstep.train_chunk(state, prior, xt, t_steps=8, unroll=unroll, **kw)
    for a, b, c in zip((whole.nat.dir_nat, *whole.nat.niw_nat),
                       (half.nat.dir_nat, *half.nat.niw_nat),
                       (other.nat.dir_nat, *other.nat.niw_nat)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(mets["local_evidence"], torch.cat([m1["local_evidence"],
                                                          m2["local_evidence"]]))
    assert whole.step == half.step == 8


@pytest.mark.parametrize("unroll,t_steps,match", [
    (3, 6, "not one of"), (0, 4, "not one of"), (16, 16, "not one of"),
    (4, 6, "does not divide"), (8, 4, "does not divide"),
])
def test_train_chunk_raises_on_bad_unroll(unroll, t_steps, match):
    x, _, _, prior, state = _setup(40, 3)
    with pytest.raises(ValueError, match=match):
        mixstep.train_chunk(state, prior, torch.tensor(x), rho=0.3, t_steps=t_steps,
                            unroll=unroll)


def test_runner_checks_unroll_and_reports_it():
    x, _, _, prior, state = _setup(40, 3)
    with pytest.raises(ValueError, match="not one of"):
        loop.make_mixture_runner(prior, rho=0.5, unroll=5)
    runner = loop.make_mixture_runner(prior, rho=0.5, unroll=2)
    with pytest.raises(ValueError, match="does not divide"):
        runner(state, torch.tensor(x), 3)
    st, mets = runner(state, torch.tensor(x), 4)
    assert mets["unroll"] == 2 and st.step == 4
    assert set(mets) == {"local_evidence", "elbo", "rho", "unroll"}
    gkl = gmm.kl_global(st.nat, prior)  # the post-chunk naturals' global KL
    np.testing.assert_allclose(mets["elbo"].numpy(),
                               (mets["local_evidence"] - gkl).numpy(), rtol=1e-6)
    # on CPU tensors the runner runs the plain version, whatever U
    st_p, mets_p = mixstep.train_chunk_plain(state, prior, torch.tensor(x), rho=0.5,
                                             t_steps=4)
    assert torch.equal(st_p.nat.dir_nat, st.nat.dir_nat)
    assert torch.equal(mets_p["local_evidence"], mets["local_evidence"])


def test_gate_and_wrapper_rejections():
    ok = dict(data_dim=2, batch_full=True, rho=0.1, num_points=400, num_components=10)
    assert mixstep.unsupported_reason(**ok) is None
    for bad, match in ((dict(data_dim=3), "2-D data"), (dict(batch_full=False), "full batch"),
                       (dict(rho=lambda t: 0.1), "constant rho"),
                       (dict(num_points=mixstep.MAX_POINTS + 1), "N = "),
                       (dict(num_components=mixstep.MAX_COMPONENTS + 1), "K = ")):
        assert match in mixstep.unsupported_reason(**{**ok, **bad})
    _, _, _, prior, state = _setup(40, 3)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mixstep.train_chunk(state, prior, torch.zeros((40, 2), device="meta"),
                            rho=0.3, t_steps=1)


@pytest.mark.parametrize("entry", [train_gmm, train_smm])
def test_entries_check_unroll_engine_and_device(entry, monkeypatch):
    base = ["--device", "cpu", "--steps", "12", "--eval-every", "4"]
    with pytest.raises(ValueError, match="not one of"):
        entry.main([*base, "--unroll", "3"])
    with pytest.raises(ValueError, match="does not divide"):
        entry.main([*base, "--unroll", "8"])
    with pytest.raises(ValueError, match="does not divide"):  # the short last chunk
        entry.main(["--device", "cpu", "--steps", "10", "--eval-every", "4",
                    "--unroll", "4"])
    with pytest.raises(ValueError, match="needs the kernel engine"):
        entry.main([*base, "--unroll", "2", "--engine", "plain"])
    out = entry.main([*base, "--unroll", "4", "--init", "kmeanspp"])
    assert out["state"].step == 12 and [r["step"] for r in out["rows"]] == [4, 8, 12]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--device", "cuda", "--steps", "4"])


def test_train_gmm_refuses_fused_kernel_on_the_kernel_engine():
    with pytest.raises(ValueError, match="--fused-kernel"):
        train_gmm.main(["--device", "cpu", "--steps", "4", "--fused-kernel"])
    out = train_gmm.main(["--device", "cpu", "--steps", "4", "--engine", "plain",
                          "--fused-kernel", "--eval-every", "2"])
    assert [r["step"] for r in out["rows"]] == [1, 2, 4]


def test_train_smm_runs_with_outliers():
    out = train_smm.main(["--device", "cpu", "--steps", "6", "--outliers", "7",
                          "--eval-every", "3"])
    assert out["state"].step == 6
    assert isinstance(out["state"], SmmTrainState)
    assert out["state"].nat.dir_nat.sum() > 400  # 400 + 7 points
    assert isinstance(train_gmm.main(["--device", "cpu", "--steps", "2"])["state"],
                      GmmTrainState)
