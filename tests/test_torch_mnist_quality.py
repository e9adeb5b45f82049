"""``svax_torch.mnist_quality``: a cut run of both configs (16-16 nets,
6 + 3 warmup steps, bigk-dp at K = 6 and batch 64) returns the reference
row's keys (``runs/mnist_quality.json``) with finite values, and the
entry never writes the reference's artifact."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from svax_torch import mnist_quality
from svax_torch.configs import CONFIGS

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["mnist-svae", "bigk-dp"])
def test_cut_run_returns_the_reference_row(name):
    ref = json.loads((ROOT / "runs" / "mnist_quality.json").read_text())[name]
    cfg = dict(CONFIGS[name], encoder_hidden=[16, 16], decoder_hidden=[16, 16], steps=6,
               warmup_steps=3, scan_chunk=3, batch_size=64,
               num_components=6 if name == "bigk-dp" else 10)
    row = mnist_quality.run_config(name, iw_samples=3, device="cpu", cfg=cfg)
    assert set(row) == set(ref)
    assert row["steps"] == 6 and row["iw_samples"] == 3 and row["synthetic_data"]
    for key in ("final_train_elbo_per_point", "test_elbo_per_point", "test_iw_per_point",
                "test_cluster_purity"):
        assert np.isfinite(row[key]), key
    assert 0.0 < row["test_cluster_purity"] <= 1.0
    assert 1 <= row["components_used"] <= cfg["num_components"]


def test_entry_refuses_the_reference_artifact():
    with pytest.raises(ValueError, match="reference's artifacts"):
        mnist_quality.main(["--device", "cpu", "--out", "runs/mnist_quality.json"])
    assert mnist_quality.DEFAULT_OUT == "runs/mnist_quality_torch.json"
