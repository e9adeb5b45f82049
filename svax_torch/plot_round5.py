"""Render the round-5 evidence figures from committed artifacts
(``experiments/plot_round5.py``).

    python -m svax_torch.plot_round5 [--out-dir docs/figures/torch]
        [--runs-dir runs] [--comparison PATH] [--impute-quality PATH]
        [--canonical-rs2 PATH] [--canonical-rs5 PATH] [--redraw PATH]

Writes three PNGs into ``--out-dir``:

- ``comparison_paired.png``: the per-seed paired deltas (SVAE − VAE
  held-out IW) per dataset, with mean ± sem and the win count, from
  ``--comparison`` (default ``runs/comparison.json``);
- ``impute_quality.png``: the impute endpoint against mean-fill and a
  matched-budget VAE (mnist masked-pixel NLL and bit error, pinwheel
  hidden-coordinate RMSE), from ``--impute-quality`` (default
  ``runs/impute_quality.json``);
- ``seed_distributions.png``: the 32-seed canonical sweeps (best-of-2 and
  best-of-5 against the exact-GMM bar) and the 32-redraw per-draw gaps,
  from ``--canonical-rs2``, ``--canonical-rs5`` and ``--redraw`` (default
  ``runs/seed_sweep_r5_mega_default32.json``, ``..._rs5_32.json`` and
  ``runs/seed_sweep_r5_redraw_rs5_32.json``).

Each input defaults to the reference's file under ``--runs-dir``, so this
renders the reference's figures from the reference's files; the port's
artifacts of the same schema (``runs/seed_sweep_torch_rs5_32.json``,
``runs/impute_quality_torch.json``, ``runs/comparison_torch.json``) can be
passed instead. Pure matplotlib on JSON (imported on the first figure, with
the Agg backend): no device, deterministic. The default ``--out-dir`` is
``docs/figures/torch``, so the reference's figures in ``docs/figures`` stay
as they are.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from svax_torch.utils.viz import pyplot

# Validated 3-slot categorical palette (all-pairs safe, light mode) +
# light-surface text/grid tokens.
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
GRID = "#e8e7e4"
BLUE = "#2a78d6"   # slot 1: SVAE / the paired deltas
ORANGE = "#eb6834"  # slot 2: VAE
AQUA = "#1baf7a"   # slot 3: mean-fill baseline

DEFAULT_OUT_DIR = "docs/figures/torch"  # the reference's figures are in docs/figures
# Each input flag and its default file under --runs-dir (the reference's).
INPUTS = {
    "comparison": "comparison.json",
    "impute-quality": "impute_quality.json",
    "canonical-rs2": "seed_sweep_r5_mega_default32.json",
    "canonical-rs5": "seed_sweep_r5_mega_rs5_32.json",
    "redraw": "seed_sweep_r5_redraw_rs5_32.json",
}
DATASET_LABEL = {
    "pinwheel": "pinwheel (real generator)",
    "auto": "auto (surrogate)",
    "mnist": "mnist (surrogate)",
}


def _style_axis(ax):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=INK2, labelsize=8)
    for lab in ax.get_xticklabels() + ax.get_yticklabels():
        lab.set_color(INK2)


def plot_comparison(comparison: dict, out: pathlib.Path,
                    source: str = "runs/comparison.json") -> None:
    """The per-seed paired SVAE − VAE deltas per dataset, with mean ± sem and
    the win count (``source`` names the file in the title)."""
    plt = pyplot()
    datasets = [d for d in ("pinwheel", "auto", "mnist") if d in comparison]
    fig, axes = plt.subplots(
        len(datasets), 1, figsize=(6.4, 1.55 * len(datasets)), dpi=160
    )
    fig.patch.set_facecolor(SURFACE)
    if len(datasets) == 1:
        axes = [axes]
    rng = np.random.default_rng(0)  # jitter only; data order is committed
    for ax, ds in zip(axes, datasets):
        row = comparison[ds]
        deltas = np.array(
            [
                s["iw_best"] - v["iw_best"]
                for s, v in zip(row["svae"]["per_seed"], row["vae"]["per_seed"])
            ]
        )
        pd = row["paired_delta"]
        _style_axis(ax)
        ax.axvline(0.0, color=INK2, lw=1.0, zorder=1)
        jitter = rng.uniform(-0.18, 0.18, size=deltas.shape)
        ax.scatter(
            deltas,
            jitter,
            s=34,
            color=BLUE,
            edgecolors=SURFACE,
            linewidths=1.2,
            zorder=3,
        )
        ax.errorbar(
            pd["mean"],
            -0.42,
            xerr=pd["sem"],
            fmt="o",
            ms=6,
            color=INK,
            ecolor=INK,
            elinewidth=2.0,
            capsize=3,
            zorder=4,
        )
        sig = "significant" if row.get("svae_beats_vae_significant") else (
            "VAE favored" if pd["mean"] < 0 else "within noise"
        )
        ax.text(
            0.99,
            0.94,
            f"mean Δ = {pd['mean']:+.3f} ± {pd['sem']:.3f} (sem)   "
            f"SVAE wins {pd['wins']}   [{sig}]",
            transform=ax.transAxes,
            ha="right",
            va="top",
            fontsize=8,
            color=INK2,
        )
        ax.set_ylabel(
            f"{DATASET_LABEL.get(ds, ds)}\n{row['seeds']} paired seeds",
            fontsize=8,
            color=INK,
        )
        ax.set_yticks([])
        ax.set_ylim(-0.62, 0.62)
        lim = max(abs(deltas).max(), abs(pd["mean"]) + pd["sem"]) * 1.18
        ax.set_xlim(-lim, lim)
    axes[-1].set_xlabel(
        "paired per-seed Δ held-out IW log-lik  (SVAE − VAE;  > 0 favors SVAE)",
        fontsize=8.5,
        color=INK,
    )
    axes[0].set_title(
        f"Three-dataset paired comparison ({source}, matched budgets)",
        fontsize=9.5,
        color=INK,
        loc="left",
    )
    fig.tight_layout()
    fig.savefig(out, facecolor=SURFACE, bbox_inches="tight")
    plt.close(fig)


def _bars(ax, labels, values, colors, unit, fmt="{:.3f}"):
    _style_axis(ax)
    x = np.arange(len(values))
    ax.bar(x, values, width=0.55, color=colors, zorder=3)
    for xi, v in zip(x, values):
        ax.text(
            xi,
            v,
            " " + fmt.format(v),
            ha="center",
            va="bottom",
            fontsize=7.5,
            color=INK,
        )
    ax.set_xticks(x)
    ax.set_xticklabels(labels, fontsize=7.5, color=INK)
    ax.set_ylabel(unit, fontsize=8, color=INK)
    ax.grid(axis="y", color=GRID, lw=0.8, zorder=0)
    ax.set_axisbelow(True)
    ax.margins(y=0.18)


def plot_impute(iq: dict, out: pathlib.Path, source: str = "runs/impute_quality.json") -> None:
    """The impute endpoint against mean-fill and the matched-budget VAE: mnist
    masked-pixel NLL and bit error, pinwheel hidden-coordinate RMSE."""
    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(9.2, 2.7), dpi=160)
    fig.patch.set_facecolor(SURFACE)

    m = iq["mnist"]
    _bars(
        axes[0],
        ["SVAE", "VAE", "mean-fill"],
        [m["masked_pixel_nll"]["svae_live"], m["masked_pixel_nll"]["vae"],
         m["masked_pixel_nll"]["mean_fill"]],
        [BLUE, ORANGE, AQUA],
        "masked-pixel NLL (nats/px, ↓)",
    )
    axes[0].set_title(
        "mnist (surrogate), 50% pixel mask", fontsize=8.5, color=INK, loc="left"
    )

    _bars(
        axes[1],
        ["SVAE", "VAE", "mean-fill"],
        [m["masked_pixel_err"]["svae_live"], m["masked_pixel_err"]["vae"],
         m["masked_pixel_err"]["mean_fill"]],
        [BLUE, ORANGE, AQUA],
        "masked-pixel bit error (↓)",
    )
    axes[1].set_title(
        "mnist (surrogate), 50% pixel mask", fontsize=8.5, color=INK, loc="left"
    )

    p = iq["pinwheel"]
    _bars(
        axes[2],
        ["SVAE\n(MAP)", "VAE", "mean-fill"],
        [p["rmse"]["svae_map"], p["rmse"]["vae"], p["rmse"]["mean_fill"]],
        [BLUE, ORANGE, AQUA],
        "hidden-coordinate RMSE (↓)",
        fmt="{:.2f}",
    )
    axes[2].set_title(
        "pinwheel, hide-one-coordinate\n(ambiguous by construction — honest negative)",
        fontsize=8.5,
        color=INK,
        loc="left",
    )

    fig.suptitle(
        f"Serve `impute` endpoint quality ({source}; AOT tier "
        "bit-identical to live)",
        fontsize=9.5,
        color=INK,
        x=0.01,
        ha="left",
    )
    fig.tight_layout(rect=(0, 0, 1, 0.92))
    fig.savefig(out, facecolor=SURFACE, bbox_inches="tight")
    plt.close(fig)


def plot_seed_distributions(canon2: dict, canon5: dict, redraw: dict,
                            out: pathlib.Path) -> None:
    """The canonical 32-seed sweeps (best-of-2 and best-of-5 against the
    exact-GMM bar) and the redraw protocol's per-draw gaps to the bar."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(6.4, 3.6), dpi=160)
    fig.patch.set_facecolor(SURFACE)
    rng = np.random.default_rng(0)  # jitter only; data order is committed

    # Canonical protocol: 32 model seeds on the fixed seed-0 draw.
    ax = axes[0]
    _style_axis(ax)
    bar = canon2["results"]["aug0.4+rs2"]["rows"][0]["gmm_bar"]
    ax.axvline(bar, color=INK, lw=1.2, zorder=2)
    ax.text(bar, 1.52, f" exact-GMM bar {bar:.2f}", fontsize=7.5,
            color=INK, ha="left", va="top")
    for y, (label, blob, color) in enumerate([
        ("best-of-2", canon2["results"]["aug0.4+rs2"], ORANGE),
        ("best-of-5", canon5["results"]["aug0.4+rs5"], BLUE),
    ]):
        iw = np.array([r["iw_per_point"] for r in blob["rows"]])
        cross = int(sum(r["crossed"] for r in blob["rows"]))
        jitter = rng.uniform(-0.16, 0.16, size=iw.shape)
        ax.scatter(iw, y + jitter, s=26, color=color, edgecolors=SURFACE,
                   linewidths=1.0, zorder=3)
        ax.plot([np.median(iw)] * 2, [y - 0.26, y + 0.26], color=INK,
                lw=2.0, zorder=4)
        ax.text(0.01, 0.32 + 0.46 * y,
                f"{label}: median {np.median(iw):.2f}, {cross}/{len(iw)} cross",
                transform=ax.transAxes, ha="left", va="center", fontsize=8,
                color=color)
    ax.set_yticks([0, 1])
    ax.set_yticklabels(["rs2", "rs5"], fontsize=8, color=INK)
    ax.set_ylim(-0.55, 1.55)
    ax.set_title("Canonical protocol, 32 model seeds (megakernel engine): "
                 "held-out IW/point", fontsize=9, color=INK, loc="left")

    # Redraw protocol: 32 fresh data draws, per-draw bars.
    ax = axes[1]
    _style_axis(ax)
    rows = redraw["results"]["aug0.6+rs5+steps30000"]["rows"]
    gap = np.array([r["iw_per_point"] - r["gmm_bar"] for r in rows])
    cross = int(sum(r["crossed"] for r in rows))
    ax.axvline(0.0, color=INK, lw=1.2, zorder=2)
    jitter = rng.uniform(-0.16, 0.16, size=gap.shape)
    ax.scatter(gap, jitter, s=26, color=AQUA, edgecolors=SURFACE,
               linewidths=1.0, zorder=3)
    ax.plot([np.median(gap)] * 2, [-0.26, 0.26], color=INK, lw=2.0, zorder=4)
    ax.text(0.99, 0.88,
            f"median gap {np.median(gap):+.3f} nat, {cross}/{len(gap)} cross",
            transform=ax.transAxes, ha="right", va="top", fontsize=8,
            color=INK2)
    ax.set_yticks([])
    ax.set_ylim(-0.55, 0.55)
    ax.set_xlabel("IW/point − per-draw exact-GMM bar  (> 0 = crosses)",
                  fontsize=8.5, color=INK)
    ax.set_title("Redraw protocol, 32 fresh draws (best-of-5): gap to each "
                 "draw's own bar", fontsize=9, color=INK, loc="left")

    fig.tight_layout()
    fig.savefig(out, facecolor=SURFACE, bbox_inches="tight")
    plt.close(fig)


def main(argv: list[str] | None = None) -> list[pathlib.Path]:
    """Render the three figures; returns their paths."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--runs-dir", default="runs")
    for flag, name in INPUTS.items():
        ap.add_argument(f"--{flag}", default=None,
                        help=f"(default: --runs-dir/{name})")
    args = ap.parse_args(argv)
    runs = pathlib.Path(args.runs_dir)
    paths = {flag: pathlib.Path(getattr(args, flag.replace("-", "_")) or runs / name)
             for flag, name in INPUTS.items()}
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def load(flag: str) -> dict:
        return json.loads(paths[flag].read_text())

    written = [out_dir / "comparison_paired.png", out_dir / "impute_quality.png",
               out_dir / "seed_distributions.png"]
    plot_comparison(load("comparison"), written[0], str(paths["comparison"]))
    print(f"wrote {written[0]}")
    plot_impute(load("impute-quality"), written[1], str(paths["impute-quality"]))
    print(f"wrote {written[1]}")
    plot_seed_distributions(load("canonical-rs2"), load("canonical-rs5"), load("redraw"),
                            written[2])
    print(f"wrote {written[2]}")
    return written


if __name__ == "__main__":
    main()
