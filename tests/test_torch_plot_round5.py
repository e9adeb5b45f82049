"""The port's round-5 figures (``svax_torch.plot_round5``) against the JAX
package's script (``experiments/plot_round5.py``): both render from the
committed JSON artifacts into temporary directories, and each figure's
bar heights, line data and scatter offsets are equal. ``main`` writes the
three PNGs, its inputs default to the reference's files and its output to
``docs/figures/torch``; the port's own sweep artifact renders through the
same code."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.collections  # noqa: E402
import matplotlib.figure  # noqa: E402

from svax_torch import plot_round5  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNS = ROOT / "runs"


def _reference():
    spec = importlib.util.spec_from_file_location("_ref_plot_round5",
                                                  ROOT / "experiments" / "plot_round5.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(name: str) -> dict:
    return json.loads((RUNS / name).read_text())


def _figure_data(fig) -> list:
    out = []
    for ax in fig.axes:
        out.append({
            "bars": [(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches],
            "lines": [np.asarray(line.get_xydata()) for line in ax.get_lines()],
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
            "segments": [np.concatenate(c.get_segments()) for c in ax.collections
                         if isinstance(c, matplotlib.collections.LineCollection)],
            "texts": [t.get_text() for t in ax.texts],
        })
    return out


@pytest.fixture
def captured(monkeypatch):
    """The data of every figure saved while the fixture is active."""
    saved = []
    real_save = matplotlib.figure.Figure.savefig

    def keep(fig, *a, **kw):
        saved.append(_figure_data(fig))
        return real_save(fig, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", keep)
    return saved


def _assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["bars"] == w["bars"]
        assert g["texts"] == w["texts"]
        for key in ("lines", "offsets", "segments"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(a, b)


FIGURES = {
    "comparison": lambda mod, out: mod.plot_comparison(_load("comparison.json"), out),
    "impute": lambda mod, out: mod.plot_impute(_load("impute_quality.json"), out),
    "seeds": lambda mod, out: mod.plot_seed_distributions(
        _load("seed_sweep_r5_mega_default32.json"), _load("seed_sweep_r5_mega_rs5_32.json"),
        _load("seed_sweep_r5_redraw_rs5_32.json"), out),
    "seeds_port_rs5": lambda mod, out: mod.plot_seed_distributions(
        _load("seed_sweep_r5_mega_default32.json"), _load("seed_sweep_torch_rs5_32.json"),
        _load("seed_sweep_r5_redraw_rs5_32.json"), out),
}


@pytest.mark.parametrize("figure", list(FIGURES))
def test_figure_data_equals_the_reference(figure, captured, tmp_path):
    FIGURES[figure](_reference(), tmp_path / "ref.png")
    FIGURES[figure](plot_round5, tmp_path / "port.png")
    want, got = captured
    _assert_same(got, want)
    assert any(ax["bars"] or ax["offsets"] for ax in got)
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_main_writes_three_pngs_from_the_reference_files(tmp_path, captured):
    written = plot_round5.main(["--out-dir", str(tmp_path / "figs")])
    assert [p.name for p in written] == ["comparison_paired.png", "impute_quality.png",
                                         "seed_distributions.png"]
    assert all(p.stat().st_size > 1000 for p in written)
    assert len(captured) == 3
    # The defaults: the reference's inputs, the port's own output folder.
    src = (ROOT / "experiments" / "plot_round5.py").read_text()
    assert all(f'"{name}"' in src for name in plot_round5.INPUTS.values())
    assert set(plot_round5.INPUTS.values()) <= {p.name for p in RUNS.iterdir()}
    assert plot_round5.DEFAULT_OUT_DIR == "docs/figures/torch"
    assert 'default="docs/figures"' in src
