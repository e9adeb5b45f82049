"""The free-form entries: ``train_svae``'s workload flags against the
reference entry's, the kernel-or-step routing against
``megakernel_unsupported_reason``, ``evaluate`` on a free-form checkpoint and
``train_smm --batch-size``.

* engine routing: over a grid of workloads (weight decay, ρ decay,
  augmentation, batch, K, widths, latent d, data width, the dof and the
  head) the port's ``kernel_unsupported_reason`` and the reference's
  ``megakernel_unsupported_reason`` agree on None or not, and on the first
  two reasons (sharding, then weight decay); where the port's kernels are
  built for less than the reference's (K above 32 on tinystep and 64 on
  flexstep, widths other than 16-16 and 50-50 on tinystep, above 128 on
  flexstep) the port takes the per-step engine and says why;
* the overlay: ``--config X`` with explicit flags parses to the reference
  entry's namespace (``configs.apply_config``);
* free-form runs end with finite rows; ``--weight-decay`` takes the
  per-step engine with the reason; each named config's first JSON line is
  the one the entry printed before the free-form flags (at the widths
  tests/test_torch_bigk.py cuts bigk-dp to, and mnist-svae to 16-16).
"""

import contextlib
import importlib.util
import io
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svax.models.svae import SvaeConfig as JConfig
from svax.train.loop import megakernel_unsupported_reason
from svax_torch import configs, evaluate, train_smm, train_svae
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops import flexstep, tinystep
from svax_torch.train import graph as cuda_graph
from svax_torch.train import loop

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _route(k, d, hidden, *, wd=0.0, decay=0.0, aug=0.0, full=True, dof=0.0, head="diag",
           d_in=2, likelihood="gaussian", dp=False, decoder_hidden=None):
    """(port's reason, reference's reason) for one workload."""
    kw = dict(latent_dim=d, num_components=k, num_samples=2, num_total=400,
              likelihood=likelihood, dof=dof, encoder_head=head)
    gate = dict(batch_full=full, encoder_hidden=hidden,
                decoder_hidden=decoder_hidden or hidden, rho=0.05, rho_decay=decay,
                input_dim=d_in)
    port = loop.kernel_unsupported_reason(SvaeConfig(**kw), likelihood=likelihood,
                                          weight_decay=wd, data_parallel=dp, **gate)
    ref = megakernel_unsupported_reason(JConfig(**kw), weight_decay=wd, aug_noise=aug,
                                        data_parallel=dp, **gate)
    return port, ref


@pytest.mark.parametrize("wd,head,dof", list(itertools.product((0.0, 1e-3), ("diag", "full"),
                                                               (0.0, 4.0))))
def test_routing_agrees_with_the_reference(wd, head, dof):
    grid = itertools.product((0.0, 1e-3), (0.0, 0.4), (True, False), (5, 32),
                             (((16, 16), (16, 16)), ((50, 50), (50, 50)),
                              ((50, 50), (16, 16))), (2, 4, 8), (2, 8))
    seen = set()
    for decay, aug, full, k, (enc, dec), d, d_in in grid:
        port, ref = _route(k, d, enc, wd=wd, decay=decay, aug=aug, full=full, dof=dof,
                           head=head, d_in=d_in, decoder_hidden=dec)
        assert (port is None) == (ref is None), (decay, aug, full, k, enc, dec, d, d_in,
                                                 port, ref)
        seen.add(port is None)
        if wd > 0.0:
            assert port == loop.PLAIN_ADAM and "plain Adam only" in ref
    assert seen == ({False} if wd > 0.0 or head == "full" else {True, False})
    # A Bernoulli workload fits neither; sharding comes first, then the decay.
    assert None not in _route(10, 8, (200, 200), d_in=784, likelihood="bernoulli", wd=wd,
                              head=head, dof=dof)
    port, ref = _route(10, 2, (50, 50), wd=wd, dp=True, head=head, dof=dof)
    assert port == loop.SINGLE_DEVICE and "single-device" in ref


@pytest.mark.parametrize("k,hidden,d,dof", [(33, (50, 50), 2, 0.0), (64, (50, 50), 2, 0.0),
                                            (100, (50, 50), 2, 0.0), (10, (32, 32), 2, 0.0),
                                            (10, (100, 100), 2, 4.0), (33, (50, 50), 2, 4.0),
                                            (10, (200, 200), 4, 0.0),
                                            (65, (100, 100), 4, 0.0)])
def test_shapes_beyond_the_port_kernels_take_the_per_step_engine(k, hidden, d, dof):
    """The reference's kernels take any K and width; the port's are built for
    tinystep K <= 32 and 16-16 or 50-50, flexstep K <= 64 and widths <= 128
    (and the GMM prior only)."""
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=2, num_total=400,
                        dof=dof)
    gate = dict(batch_full=True, encoder_hidden=hidden, decoder_hidden=hidden, rho=0.05,
                input_dim=2)
    _, ref = _route(k, d, hidden, dof=dof)
    assert ref is None
    chosen = loop.choose_kernel(config, engine="auto", **gate)
    fits_flex = (k <= flexstep.MAX_COMPONENTS and max(hidden) <= flexstep.MAX_HIDDEN
                 and dof == 0.0)
    fits_tiny = (d == 2 and k <= tinystep.MAX_COMPONENTS
                 and hidden in tinystep.SUPPORTED_HIDDEN)
    assert chosen == ("tinystep" if fits_tiny else "flexstep" if fits_flex else loop.PER_STEP)
    if chosen == loop.PER_STEP:
        assert "fits neither kernel" in loop.kernel_unsupported_reason(config, **gate)


class _Parsed(Exception):
    pass


def _reference_args(argv, monkeypatch):
    """The reference entry's namespace after its config overlay."""
    monkeypatch.syspath_prepend(str(ROOT))
    import configs as ref_configs

    real = ref_configs.apply_config

    def capture(args, parser, argv_=None):
        real(args, parser, argv_)
        raise _Parsed(args)

    monkeypatch.setattr(ref_configs, "apply_config", capture)
    monkeypatch.setattr(sys, "argv", ["train_svae.py", *argv])
    spec = importlib.util.spec_from_file_location("_ref_train_svae",
                                                  ROOT / "experiments" / "train_svae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Parsed) as got:
        mod.main()
    return vars(got.value.args[0])


SHARED = ("config", "dataset", "num_components", "latent_dim", "num_samples",
          "encoder_hidden", "decoder_hidden", "steps", "batch_size", "lr", "aug_noise",
          "weight_decay", "warmup_steps", "rho", "rho_decay", "alpha", "kappa", "seed",
          "eval_every", "scan_chunk", "iw_samples", "nn_precision", "nn_compute_dtype",
          "fused_mlp_decoder", "fused_combine", "kernel_rng", "dp", "encoder_head",
          "recon_mode", "smm_dof", "smm_iters", "remat", "remat_decoder")


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "auto", "-L", "4", "-K", "6", "--batch-size", "32", "--weight-decay", "0.01"],
    ["--config", "pinwheel-svae", "--steps", "100", "--rho", "0.05"],
    ["--config", "auto-svae", "--batch-size", "0", "--aug-noise", "0.2", "-S", "2"],
    ["--config", "mnist-svae", "-K", "5", "--warmup-steps", "0", "--nn-precision", "high"],
    ["--config", "bigk-dp", "--encoder-hidden", "64", "64", "--kappa", "0.1"],
])
def test_config_overlay_matches_the_reference(argv, monkeypatch):
    ref = _reference_args(argv, monkeypatch)
    _, args = train_svae.parse_args(argv)
    got = vars(args)
    for dest in SHARED:
        assert got[dest] == ref[dest], (dest, got[dest], ref[dest])
    # The configs' engine "auto" is the port's kernel rule.
    assert got["engine"] == ("kernel" if ref["engine"] in ("auto", "xla") else ref["engine"])


def _first_line(argv) -> tuple[dict, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_svae.main(argv)
    return json.loads(buf.getvalue().splitlines()[0]), out


def test_free_form_runs_and_weight_decay_takes_the_per_step_engine(monkeypatch):
    first, out = _first_line(["--device", "cpu", "--steps", "6", "--scan-chunk", "3",
                              "--iw-samples", "3", "--aug-noise", "0.3", "-K", "6"])
    assert first["config"] is None and first["kernel"] == "tinystep" and first["why"] is None
    assert [r["step"] for r in out["rows"]] == [3, 6]
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert np.isfinite(out["final_test_iw_loglik_per_point"])
    assert out["state"].pgm_nat.dir_nat.shape == (6,)
    first, out = _first_line(["--device", "cpu", "--steps", "5", "--eval-every", "2",
                              "--iw-samples", "0", "--weight-decay", "0.01", "--dataset",
                              "auto", "-L", "3", "--encoder-hidden", "16", "16",
                              "--decoder-hidden", "16", "16", "--batch-size", "32"])
    assert first["kernel"] == loop.PER_STEP and first["why"] == loop.PLAIN_ADAM
    assert first["batch"] == 32 and first["d_in"] == 8
    assert [r["step"] for r in out["rows"]] == [1, 2, 4, 5]  # the per-step loop's rows
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    with pytest.raises(SystemExit):
        train_svae.main(["--device", "cpu", "--steps", "1", "--weight-decay", "0.01",
                         "--engine", "megakernel"])
    # Where matplotlib is missing (the card machine), --plot raises an
    # error naming it before training.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        train_svae.main(["--device", "cpu", "--steps", "1", "--plot", "x.png"])


# Each named config's first line as the entry printed it before the
# free-form flags (mnist-svae at 16-16, bigk-dp at K = 6, 16-16, batch 64;
# one thread), with the "graph" route the graphed runners added.
NAMED_FIRST = {
    "pinwheel-svae": dict(config="pinwheel-svae", kernel="tinystep", why=None,
                          graph=cuda_graph.KERNEL_CHUNK,
                          fused_combine=False, fused_mlp_decoder=False, nn_precision="default",
                          nn_compute_dtype="float32", n=400, d_in=2, batch=400,
                          synthetic=False, init_test_elbo_per_point=-77.47525787353516),
    "auto-svae": dict(config="auto-svae", kernel="flexstep", why=None,
                      graph=cuda_graph.KERNEL_CHUNK, fused_combine=False,
                      fused_mlp_decoder=False, nn_precision="default",
                      nn_compute_dtype="float32", n=352, d_in=8, batch=64, synthetic=True,
                      init_test_elbo_per_point=-16.844181060791016),
    "mnist-svae": dict(config="mnist-svae", kernel="per-step",
                       why="fits neither kernel: the tinystep kernel needs latent d = 2 "
                           "(got 8); the flexstep kernel needs 2 <= latent d <= 6 (got 8)",
                       graph=cuda_graph.CPU_EAGER, fused_combine=True,
                       fused_mlp_decoder=False, nn_precision="high",
                       nn_compute_dtype="bfloat16", n=6000, d_in=784, batch=256,
                       synthetic=True, init_test_elbo_per_point=-550.3582153320312),
    "bigk-dp": dict(config="bigk-dp", kernel="per-step", why=loop.SINGLE_DEVICE,
                    graph=cuda_graph.CPU_EAGER, fused_combine=True,
                    fused_mlp_decoder=True, nn_precision="high",
                    nn_compute_dtype="bfloat16", n=6000, d_in=784, batch=64, synthetic=True,
                    init_test_elbo_per_point=-552.9021606445312),
}
COMMON_FIRST = dict(engine="kernel", fused_decoder=False, encoder_head="diag",
                    recon_mode="weighted", remat_combine=False, remat_decoder=False,
                    prior="gmm", dof=0.0, smm_iters=2, smm_envelope_grads=False,
                    world_size=1, data=1, comp=1)


@pytest.mark.parametrize("name", list(NAMED_FIRST))
def test_named_configs_first_line_is_unchanged(name, monkeypatch):
    monkeypatch.setitem(configs.CONFIGS, "mnist-svae", dict(
        configs.CONFIGS["mnist-svae"], encoder_hidden=[16, 16], decoder_hidden=[16, 16]))
    monkeypatch.setitem(configs.CONFIGS, "bigk-dp", dict(
        configs.CONFIGS["bigk-dp"], num_components=6, encoder_hidden=[16, 16],
        decoder_hidden=[16, 16], batch_size=64))
    first, out = _first_line(["--config", name, "--device", "cpu", "--steps", "1",
                              "--warmup-steps", "0", "--iw-samples", "0"])
    want = {**COMMON_FIRST, **NAMED_FIRST[name]}
    assert set(first) == set(want)
    init = first.pop("init_test_elbo_per_point")
    np.testing.assert_allclose(init, want.pop("init_test_elbo_per_point"), rtol=1e-6)
    assert first == want
    assert out["rows"][-1]["step"] == 1


def test_evaluate_scores_a_free_form_checkpoint(tmp_path):
    flags = ["--dataset", "auto", "-L", "3", "-K", "4", "--encoder-hidden", "16", "16",
             "--decoder-hidden", "16", "16", "--device", "cpu"]
    run = train_svae.main([*flags, "--batch-size", "32", "--steps", "4", "--scan-chunk", "2",
                           "--checkpoint-dir", str(tmp_path), "--iw-samples", "5"])
    assert run["kernel"] == "flexstep"
    ev = evaluate.main(["--checkpoint-dir", str(tmp_path), *flags, "--iw-samples", "5"])
    assert ev["checkpoint_step"] == 4
    assert ev["test_elbo_per_point"] == run["rows"][-1]["test_elbo_per_point"]
    assert ev["test_iw_loglik_per_point"] == run["final_test_iw_loglik_per_point"]
    with pytest.raises(SystemExit):
        evaluate.main(["--checkpoint-dir", str(tmp_path), "--config", "pinwheel-gmm",
                       "--device", "cpu"])


def test_train_smm_minibatch_runs_on_the_plain_engine():
    out = train_smm.main(["--device", "cpu", "--steps", "6", "--eval-every", "3",
                          "--engine", "plain", "--batch-size", "50"])
    assert [r["step"] for r in out["rows"]] == [1, 3, 6]
    assert all(np.isfinite(r["elbo"]) for r in out["rows"])
    assert out["state"].step == 6
    full = train_smm.main(["--device", "cpu", "--steps", "6", "--eval-every", "3",
                           "--engine", "plain"])
    assert full["rows"][-1]["elbo"] != out["rows"][-1]["elbo"]
    with pytest.raises(ValueError, match="--engine kernel"):
        train_smm.main(["--device", "cpu", "--steps", "6", "--batch-size", "50"])
