"""The port's figures (``svax_torch.utils.viz``) against the JAX package's
(``svax/utils/viz.py``), and ``--plot`` on the port's entries.

* ``plot_gmm_clusters`` into two Agg axes, from a JAX
  ``gmm.init_variational`` naturals converted by
  ``convert.gmm_nat_from_numpy``: every ellipse line's xy data and the
  scatter offsets equal to 1e-5, the face colours equal, at d = 2 and 4
  (the first two axes drawn), with a ``min_weight`` that drops a
  component and one that drops none;
* ``plot_training_curves``' line data from one JSONL;
* each entry's ``--plot`` on the CPU at a few steps writes a non-empty
  PNG: ``train_svae`` (GMM and ``--smm-dof 4``), ``evaluate``,
  ``train_gmm``, ``train_smm``; without matplotlib ``--plot`` raises an
  error naming it before any training.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from svax.pgm import gmm as jgmm  # noqa: E402
from svax.utils import viz as jviz  # noqa: E402
from svax_torch import convert  # noqa: E402
from svax_torch.utils import viz  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _axes_data(ax) -> dict:
    return {
        "lines": [np.asarray(line.get_xydata()) for line in ax.get_lines()],
        "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
        "faces": [np.asarray(c.get_facecolors()) for c in ax.collections],
        "title": ax.get_title(),
    }


def _assert_same(got: dict, want: dict) -> None:
    assert len(got["lines"]) == len(want["lines"])
    for a, b in zip(got["lines"], want["lines"]):
        np.testing.assert_allclose(a, b, **TOL)
    assert len(got["offsets"]) == len(want["offsets"])
    for a, b in zip(got["offsets"], want["offsets"]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(got["faces"], want["faces"]):
        np.testing.assert_array_equal(a, b)
    assert got["title"] == want["title"]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("min_weight", [0.001, 0.05])
def test_plot_gmm_clusters_matches_the_reference(d, min_weight):
    k, n = 5, 60
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)) * 3.0
    logits = rng.standard_normal((n, k))
    logits[:, 0] -= 4.0  # component 0 holds ~0.6% of the mass: 0.05 drops it
    resp = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    prior = jgmm.make_prior(k, d, kappa=0.05)
    jnat = jgmm.init_variational(jax.random.PRNGKey(d), prior,
                                 data=jax.numpy.asarray(x), pseudo_counts=3.0)
    nat = convert.gmm_nat_from_numpy(jax.tree.map(np.asarray, jnat))
    share = resp.sum(0) / resp.sum()
    assert (share < min_weight).sum() == (1 if min_weight == 0.05 else 0)

    fig, (ax_ref, ax_port) = plt.subplots(1, 2)
    jviz.plot_gmm_clusters(x, resp, jnat, None, title="t", min_weight=min_weight, ax=ax_ref)
    viz.plot_gmm_clusters(torch.tensor(x), torch.tensor(resp), nat, None, title="t",
                          min_weight=min_weight, ax=ax_port)
    want, got = _axes_data(ax_ref), _axes_data(ax_port)
    plt.close(fig)
    assert len(want["lines"]) == k - (1 if min_weight == 0.05 else 0)
    _assert_same(got, want)


def test_plot_training_curves_matches_the_reference(tmp_path, monkeypatch):
    rows = [{"step": s, "wall_s": 0.1 * s, "elbo": -50.0 + s,
             "test_elbo_per_point": -9.0 + 0.1 * s} for s in (1, 5, 10, 20)]
    rows.insert(2, {"step": 7, "note": "no elbo"})
    log = tmp_path / "run.jsonl"
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    saved = []
    real_save = matplotlib.figure.Figure.savefig

    def keep(fig, *a, **kw):
        saved.append([_axes_data(ax) for ax in fig.axes])
        return real_save(fig, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", keep)
    keys = ("elbo", "test_elbo_per_point", "missing")
    jviz.plot_training_curves(log, tmp_path / "ref.png", keys=keys)
    viz.plot_training_curves(log, tmp_path / "port.png", keys=keys)
    want, got = saved
    assert len(got[0]["lines"]) == 2
    _assert_same(got[0], want[0])
    assert (tmp_path / "port.png").stat().st_size > 0


def _ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ck")
    from svax_torch import train_svae

    train_svae.main(["--device", "cpu", "--steps", "3", "--iw-samples", "0",
                     "--checkpoint-dir", str(path), "-K", "4", "--encoder-hidden", "16",
                     "16", "--decoder-hidden", "16", "16"])
    return path


@pytest.mark.parametrize("entry", ["train_svae", "train_svae_smm", "evaluate", "train_gmm",
                                   "train_smm"])
def test_entry_plot_writes_a_png(entry, tmp_path, tmp_path_factory):
    from svax_torch import evaluate, train_gmm, train_smm, train_svae

    png = tmp_path / "fig" / "plot.png"
    small = ["-K", "4", "--encoder-hidden", "16", "16", "--decoder-hidden", "16", "16"]
    runs = {
        "train_svae": lambda: train_svae.main(["--device", "cpu", "--steps", "3",
                                               "--iw-samples", "0", *small,
                                               "--plot", str(png)]),
        "train_svae_smm": lambda: train_svae.main(["--device", "cpu", "--steps", "3",
                                                   "--iw-samples", "0", "--smm-dof", "4",
                                                   *small, "--plot", str(png)]),
        "evaluate": lambda: evaluate.main(["--checkpoint-dir", str(_ckpt(tmp_path_factory)),
                                           "--device", "cpu", "--iw-samples", "2", *small,
                                           "--plot", str(png)]),
        "train_gmm": lambda: train_gmm.main(["--config", "pinwheel-gmm", "--device", "cpu",
                                             "--steps", "4", "--eval-every", "2",
                                             "--plot", str(png)]),
        "train_smm": lambda: train_smm.main(["--device", "cpu", "--steps", "4",
                                             "--eval-every", "2", "--plot", str(png)]),
    }
    runs[entry]()
    assert png.stat().st_size > 1000
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_names_it(monkeypatch, tmp_path):
    from svax_torch import robustness_demo, train_gmm

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for run in (lambda: train_gmm.main(["--device", "cpu", "--steps", "2", "--plot",
                                        str(tmp_path / "a.png")]),
                lambda: robustness_demo.main(["--device", "cpu", "--steps", "2", "--plot",
                                              str(tmp_path / "b.png")])):
        with pytest.raises(ImportError, match="matplotlib"):
            run()
    assert not list(tmp_path.iterdir())
