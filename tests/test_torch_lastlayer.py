"""The last-layer engine's forward block (``ops/csrc/lastlayer.cuh``: block
(f), ``rowsum_slabs``), held on the CPU through Python mirrors: the f32
mode's products emulated as the kernels form them (each operand in three
bf16 parts, the six terms of order < 3, each 16-deep k-step added in f32)
against f64, beside one- and two-part products that miss the bar; the
forward blocks' shared memory within the card's limit across the shape
classes; and the configurations' job tiling. The card tests
(``tests/test_torch_cuda_decoder_*.py``) compare the shared-memory mirrors
with the C entries.
"""

import pytest
import torch

from svax_torch.measure_mnist import ROWSUM_S_F64_TOL, rowsum_inputs, rowsum_s_f64_error
from svax_torch.ops import decoder, decoder_mlp

torch.set_num_threads(1)


def _parts(x: torch.Tensor, parts: int) -> list:
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _engine_o(h: torch.Tensor, w: torch.Tensor, parts: int) -> torch.Tensor:
    """o = h @ w as block (f) forms it: per 16-deep k-step the terms of
    order < parts, smallest first, into a zeroed f32 tile (each term a sum of
    16 products of bf16 values, exact in f64 and rounded to f32 as the tensor
    cores' sum is), the tile added to o in f32."""
    ph, pw = _parts(h, parts), _parts(w, parts)
    o = torch.zeros(h.shape[0], w.shape[1])
    for k0 in range(0, h.shape[1], 16):
        t = torch.zeros_like(o)
        for order in range(parts - 1, -1, -1):
            for i in range(min(order, parts - 1), -1, -1):
                t = t + (ph[i][:, k0:k0 + 16].double() @ pw[order - i][k0:k0 + 16].double()).float()
        o = o + t
    return o


def _engine_rowsum(h, w, b, parts: int) -> torch.Tensor:
    """s as block (f) forms it from ``_engine_o``: logσ(−(o + b)) in f32, the
    row's values summed exactly (its Kahan sums and f64 partials) and
    rounded to f32 once."""
    vals = torch.nn.functional.logsigmoid(-(_engine_o(h, w, parts) + b))
    return vals.double().sum(dim=-1).float()


@pytest.mark.parametrize("parts,meets", [(3, True), (2, False), (1, False)])
def test_f32_mode_forward_meets_the_f64_bar_only_with_three_parts(parts, meets):
    """ROWSUM_S_F64_TOL, the f32 mode's bar on s against f64: the engine's
    six-term three-part products meet it; products of two-part splits (three
    terms, within ~2⁻¹⁶) and of bf16-rounded operands miss it."""
    h, w, b, _ = rowsum_inputs("cpu", 1000, 200, 784)
    err = rowsum_s_f64_error(_engine_rowsum(h, w, b, parts), h, w, b)
    assert (err <= ROWSUM_S_F64_TOL) == meets, err


@pytest.mark.parametrize("bf16", [True, False])
def test_rowsum_forward_smem_fits_every_width(bf16):
    """Every Dh of the class (1..MAX_HIDDEN) has a forward block within the
    card's shared memory; the narrow configuration takes every padded width
    up to its cap (224: every config's 200) and the wide one the rest."""
    narrow = decoder.FWD_NARROW[bf16]
    for dh in range(1, decoder.MAX_HIDDEN + 1):
        kp = -(-dh // 16) * 16
        got = decoder.forward_smem_bytes(dh, bf16)
        assert 0 < got <= decoder.SMEM_LIMIT, (dh, got)
        parts = 1 if bf16 else 3
        want = decoder._fwd_block_bytes(narrow if kp <= narrow[3] else decoder.FWD_WIDE, kp,
                                        parts)
        assert got == want, (dh, got, want)


@pytest.mark.parametrize("rows", [2560, 51200, 102400])
def test_decoder_forward_smem_fits_every_width(rows):
    """Every pair of hidden widths of the class (1..MAX_HIDDEN) at the mnist,
    shard and bigk row counts has a forward block within the card's shared
    memory; at padded widths ≤ 224 two blocks share an SM (each within
    half of it, less the 1 KB the card keeps a block)."""
    for h1 in range(1, decoder_mlp.MAX_HIDDEN + 1, 3):
        for h2 in range(1, decoder_mlp.MAX_HIDDEN + 1, 5):
            got = decoder_mlp.forward_smem_bytes(h1, h2, rows)
            assert 0 < got <= decoder_mlp.SMEM_LIMIT, (h1, h2, got)
            if max(-(-h1 // 16), -(-h2 // 16)) * 16 <= 224:
                assert got <= (233_472 - 2 * 1024) // 2, (h1, h2, got)


def test_decoder_forward_takes_small_blocks_only_for_few_rows():
    """32-row blocks below FWD_SMALL_ROWS (the mnist shape: 80 blocks, not
    40), 64-row blocks at bigk and its shards; the 64-row block's region is
    the larger."""
    small = decoder_mlp.forward_smem_bytes(200, 200, 2560)
    big = decoder_mlp.forward_smem_bytes(200, 200, 102400)
    assert small < big
    assert decoder_mlp.forward_smem_bytes(200, 200, decoder_mlp.FWD_SMALL_ROWS) == big
    assert decoder_mlp.forward_smem_bytes(200, 200, decoder_mlp.FWD_SMALL_ROWS - 1) == small


@pytest.mark.parametrize("cfg", [*decoder.FWD_NARROW.values(), decoder.FWD_WIDE,
                                 (32, 64, 2, 224, 8, 1), (64, 64, 2, 224, 8, 2)])
def test_forward_configurations_tile_each_slab_with_whole_jobs(cfg):
    """lastlayer.cuh: CfgF's static_assert, mirrored: the warps' o jobs (FMI
    m16 tiles × one n16 pair) cover the TM × SN tile of a slab once each,
    every warp the same number of jobs (the row sums' partials per row are
    the warps of its job row). The last two: decoder_mlp.cu's FwdCfg."""
    tm, sn, _, _, warps, fmi = cfg
    jr = 16 * fmi
    jm = tm // jr
    assert jm * jr == tm and warps % jm == 0
    wj = warps // jm
    jw = sn // 16 // wj
    assert jw * wj * 16 == sn
    cover = torch.zeros(tm // 16, sn // 16, dtype=torch.int64)
    for w in range(warps):
        for j in range(jw):
            om, on = (w % jm) * jr // 16, w // jm + wj * j
            cover[om:om + fmi, on] += 1
    assert bool((cover == 1).all())


def test_fast_logsig_formula_is_within_a_few_f32_ulps_of_f64():
    """lastlayer.cuh: logsig_neg_fast, −(max(o, 0) + log(1 + exp(−|o|)))
    without a log1p, emulated in f32 (each step rounded; the
    special-function units' own error, ~2⁻²² of each result, is not
    modelled) against logσ(−o) in f64 over o ∈ [−100, 100]: within 2⁻²² of
    max(1, |logσ(−o)|), never positive, and where logσ(−o) is tiny (o <
    −20), within 2⁻²⁴ absolutely, as torch's f32 log_sigmoid is, though its
    relative error there is large."""
    import numpy as np

    o = np.linspace(-100.0, 100.0, 2_000_001).astype(np.float32)
    e = np.exp(-np.abs(o)).astype(np.float32)
    fast = -(np.maximum(o, np.float32(0.0)) + np.log(np.float32(1.0) + e).astype(np.float32))
    ref = -(np.maximum(o.astype(np.float64), 0.0) + np.log1p(np.exp(-np.abs(o.astype(np.float64)))))
    err = np.abs(fast.astype(np.float64) - ref)
    assert float((err / np.maximum(1.0, np.abs(ref))).max()) <= 2.0 ** -22
    assert float(fast.max()) <= 0.0
    torch_f32 = torch.nn.functional.logsigmoid(-torch.from_numpy(o)).double().numpy()
    tiny = o < -20.0
    assert float(err[tiny].max()) <= 2.0 ** -24 and float(np.abs(torch_f32 - ref)[tiny].max()) < 1e-8
