"""Whole-train-step kernel for the pinwheel SVAE: wrapper, plain version,
hand-derived backward.

Port of ``svax/ops/tinystep_pallas.py`` (the GMM and the Student-t
mixture (SMM) prior, in-kernel input-noise augmentation). ``train_chunk``
runs T complete training steps — encoder, closed-form 2×2 SIN combine (for
``dof`` > 0 the u–z coordinate rounds of ``models.svae_smm``), reparameterised
sampling, Gaussian decoder over S·N·K rows, local term, sufficient
statistics, backward, Adam, CVI — in ONE launch of the CUDA kernel in
``csrc/tinystep.cu``.

* On CUDA tensors it launches the kernel, or raises; there is no fallback.
* On CPU tensors it runs ``train_chunk_plain``: T iterations of
  ``svae_step.make_train_step`` (``svae_smm`` when dof > 0) wrapped
  in ``loop.augment_step``.
* ``step_grads_manual`` is the backward written out by hand in plain
  PyTorch — the formulas the kernel transcribes, tested on the CPU
  against autograd.

Noise: ``eps`` (T, S, N, K, 2) and ``aug_eps`` (T, N, 2) inject it (the
parity mode); otherwise the kernel draws it from an in-kernel
Philox4x32-10 + Box–Muller keyed by ``seed + state.step`` (so
consecutive chunks differ), ε on stream t and ξ on stream t + 2³⁰.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from svax_torch.models import svae_smm
from svax_torch.models.svae import SvaeConfig
from svax_torch.pgm.gmm import GmmNat
from svax_torch.expfam.niw import NiwNat
from svax_torch.train import svae_step
from svax_torch.train.svae_step import AdamState, SvaeTrainState

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
_VAR_FLOOR = 1e-6

# Hidden widths the kernel is instantiated for (encoder == decoder).
SUPPORTED_HIDDEN = ((16, 16), (50, 50))
# The kernel's shared memory holds K-sized blocks; it is sized for K <= 32.
MAX_COMPONENTS = 32

launches = 0  # kernel launches made by train_chunk (plain int)


# ------------------------------------------------------------ plain version


def train_chunk_plain(state: SvaeTrainState, prior: GmmNat, x: torch.Tensor,
                      *, lr: float, rho: float, t_steps: int,
                      num_samples: int = 4, seed: int = 0,
                      aug_noise: float = 0.0,
                      eps: torch.Tensor | None = None,
                      aug_eps: torch.Tensor | None = None,
                      dof: float = 0.0, smm_iters: int = 2,
                      smm_envelope_grads: bool = False):
    """T iterations of make_train_step + augment_step in plain PyTorch;
    ``dof`` > 0 runs the SMM-prior step (``svae_smm`` with ``smm_iters``
    rounds and ``smm_envelope_grads``).

    Returns (state, {"recon", "local_kl", "neg_loss"} of shape (T,)).
    Without injected noise it draws from a ``torch.Generator`` on
    ``x.device`` seeded ``seed + state.step``: the same distribution as
    the kernel's Philox stream, not the same numbers.
    """
    from svax_torch.train.loop import augment_step

    if aug_noise > 0.0 and (eps is None) != (aug_eps is None):
        raise ValueError("aug_noise > 0 with injected noise needs both eps "
                         "and aug_eps (or neither)")
    n = x.shape[0]
    k = prior.dir_nat.shape[0]
    s = eps.shape[1] if eps is not None else num_samples
    config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s,
                        num_total=n, dof=dof, smm_iters=smm_iters,
                        smm_envelope_grads=smm_envelope_grads)
    step = augment_step(svae_step.make_train_step(config, prior, lr, rho), aug_noise)
    gen = None
    if eps is None:
        gen = torch.Generator(device=x.device).manual_seed(seed + state.step)
    mets = {"recon": [], "local_kl": [], "neg_loss": []}
    for t in range(t_steps):
        kw = {"generator": gen}
        if eps is not None:
            kw["eps"] = eps[t]
            if aug_noise > 0.0:
                kw["aug_eps"] = aug_eps[t]
        state, m = step(state, x, **kw)
        for name in mets:
            mets[name].append(m[name])
    return state, {name: torch.stack(v) for name, v in mets.items()}


# ------------------------------------------------------ hand-written backward


def digamma(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x > 0: 8-step recurrence into the asymptotic series (the
    kernel's recurrence; ~1e-9 accurate)."""
    acc = torch.zeros_like(x)
    for i in range(8):
        acc = acc + 1.0 / (x + float(i))
    y = x + 8.0
    inv = 1.0 / y
    inv2 = inv * inv
    series = torch.log(y) - 0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)
    )
    return series - acc


def expected_cols(nat: GmmNat) -> dict:
    """Expected GMM params for d=2 in closed form, each (K,): the kernel's
    map (mirrors gmm.expected_params / niw.expected_stats)."""
    alpha = nat.dir_nat + 1.0
    e_log_pi = digamma(alpha) - digamma(alpha.sum())
    eta1, kappa, eta3, eta4 = nat.niw_nat
    m1 = eta1[:, 0] / kappa
    m2 = eta1[:, 1] / kappa
    phi11 = eta3[:, 0, 0] - kappa * m1 * m1
    phi12 = eta3[:, 0, 1] - kappa * m1 * m2
    phi22 = eta3[:, 1, 1] - kappa * m2 * m2
    nu = eta4 - 4.0  # η₄ = ν + d + 2, d = 2
    det = phi11 * phi22 - phi12 * phi12
    i11, i12, i22 = phi22 / det, -phi12 / det, phi11 / det
    pim1 = i11 * m1 + i12 * m2
    pim2 = i12 * m1 + i22 * m2
    return dict(
        log_pi=e_log_pi,
        prec11=nu * i11, prec12=nu * i12, prec22=nu * i22,
        pm1=nu * pim1, pm2=nu * pim2,
        quad=2.0 / kappa + nu * (m1 * pim1 + m2 * pim2),
        logdet=digamma(nu / 2.0) + digamma((nu - 1.0) / 2.0) + 2.0 * _LOG_2
        - torch.log(det),
    )


def mlp3_fwd(layers, x):
    a1 = torch.tanh(x @ layers[0]["w"] + layers[0]["b"])
    a2 = torch.tanh(a1 @ layers[1]["w"] + layers[1]["b"])
    return a1, a2, a2 @ layers[2]["w"] + layers[2]["b"]


def mlp3_bwd(layers, x, a1, a2, obar):
    """Cotangent of a tanh-tanh-linear MLP's output → (layer grads, x̄)."""
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    x, a1, a2, obar = rows(x), rows(a1), rows(a2), rows(obar)
    g2 = (obar @ layers[2]["w"].T) * (1.0 - a2 * a2)
    g1 = (g2 @ layers[1]["w"].T) * (1.0 - a1 * a1)
    grads = [
        {"w": x.T @ g1, "b": g1.sum(0)},
        {"w": a1.T @ g2, "b": g2.sum(0)},
        {"w": a2.T @ obar, "b": obar.sum(0)},
    ]
    return grads, g1 @ layers[0]["w"].T


def _z_update(e: dict, p: torch.Tensor, h: torch.Tensor, u):
    """The ū-scaled 2×2 combine on (N, K) planes: J̃ = diag(p) + ū·E[Λ],
    h̃ = h + ū·E[Λμ], Σ̃ = J̃⁻¹, μ̃ = Σ̃h̃ (ū = 1: the GMM combine)."""
    j11 = u * e["prec11"] + p[:, 0:1]
    j12 = (u * e["prec12"]).expand_as(j11)
    j22 = u * e["prec22"] + p[:, 1:2]
    ht1 = u * e["pm1"] + h[:, 0:1]
    ht2 = u * e["pm2"] + h[:, 1:2]
    det = j11 * j22 - j12 * j12
    s11, s12, s22 = j22 / det, -j12 / det, j11 / det
    return dict(j11=j11, j12=j12, j22=j22, ht1=ht1, ht2=ht2, det=det, s11=s11,
                s12=s12, s22=s22, mu1=s11 * ht1 + s12 * ht2, mu2=s12 * ht1 + s22 * ht2)


def _quad_latent(e: dict, c: dict) -> torch.Tensor:
    """Q_nk = E[(z−μ_k)ᵀΛ_k(z−μ_k)] under q(z|n,k) (svae_smm._quad_latent)."""
    mu1, mu2 = c["mu1"], c["mu2"]
    return (e["prec11"] * (c["s11"] + mu1 * mu1)
            + 2.0 * e["prec12"] * (c["s12"] + mu1 * mu2)
            + e["prec22"] * (c["s22"] + mu2 * mu2)
            - 2.0 * (e["pm1"] * mu1 + e["pm2"] * mu2) + e["quad"])


def _combine_bwd(c: dict, mu1bar, mu2bar, s11bar, s12bar, s22bar, logdetbar):
    """Cotangents of a z-update's outputs → those of its inputs: returns
    (J̄11, J̄12, J̄22, h̄t1, h̄t2). μ̃ = Σ̃h̃ with Σ̃ = adj(J̃)/det; S̄12 and
    J̄12 are the cotangents of the one off-diagonal scalar."""
    s11, s12, s22, det = c["s11"], c["s12"], c["s22"], c["det"]
    ht1bar = s11 * mu1bar + s12 * mu2bar
    ht2bar = s12 * mu1bar + s22 * mu2bar
    s11bar = s11bar + mu1bar * c["ht1"]
    s12bar = s12bar + mu1bar * c["ht2"] + mu2bar * c["ht1"]
    s22bar = s22bar + mu2bar * c["ht2"]
    detbar = (logdetbar - (s11bar * s11 + s12bar * s12 + s22bar * s22)) / det
    return (s22bar / det + detbar * c["j22"], -s12bar / det - 2.0 * detbar * c["j12"],
            s11bar / det + detbar * c["j11"], ht1bar, ht2bar)


def _u_bar(e: dict, j11bar, j12bar, j22bar, ht1bar, ht2bar):
    """ū's cotangent through J̃ = diag(p) + ūE[Λ], h̃ = h + ūE[Λμ]:
    ⟨J̄, E[Λ]⟩ + ⟨h̄t, E[Λμ]⟩."""
    return (j11bar * e["prec11"] + j12bar * e["prec12"] + j22bar * e["prec22"]
            + ht1bar * e["pm1"] + ht2bar * e["pm2"])


def step_grads_manual(nn_params: dict, nat: GmmNat, x: torch.Tensor,
                      eps: torch.Tensor, *, dof: float = 0.0, smm_iters: int = 2,
                      smm_envelope_grads: bool = False):
    """One step's forward and its backward, written out by hand.

    x (N, 2) is the (already augmented) batch, eps (S, N, K, 2). Returns
    (grads of neg_loss in the nn_params layout, aux dict with recon,
    local_kl, neg_loss and the (K,) statistics counts, u_counts, s1_1,
    s1_2, s2_11, s2_12, s2_22). Full batch: num_total = N.

    ``dof`` > 0 is the SMM prior (``svae_smm.forward``): R = max(smm_iters,
    1) u–z rounds from ū = 1, a final z-update at ū = a/b, the Student-t
    log ρ, the local term Σ r̃(log r̃ − A) and ū-weighted statistics. Its
    backward runs through the final z-update (ū enters J̃, h̃, log ρ and
    A), then — unless ``smm_envelope_grads``, where b and ū are constants —
    back through every round: b̄ → Q̄ = b̄/2 → μ̄, S̄ → J̄, h̄t, which feed p̄
    and h̄ and give ū_r's cotangent, and ū_r = a/b_{r−1} passes
    −ū̄_r·ū_r²/a on to the round before. Each round's z-update is
    recomputed from ū = 1, as the kernel does.
    """
    enc, dec = nn_params["encoder"], nn_params["decoder"]
    s, n, _, _ = eps.shape
    e = expected_cols(nat)
    smm = dof > 0.0

    # Encoder → diagonal potential.
    a1e, a2e, out = mlp3_fwd(enc, x)
    mean, raw = out[:, :2], out[:, 2:]
    var = F.softplus(raw) + _VAR_FLOOR
    p = 1.0 / var
    h = mean * p

    # Closed-form 2×2 combine on (N, K) planes; the SMM's u–z rounds first.
    u = 1.0
    if smm:
        a0, a, log_pu_const, psi_a = svae_smm.gamma_constants(dof, 2)
        b0 = a0
        rounds = max(smm_iters, 1)
        u = torch.ones_like(h[:, 0:1] * e["prec11"])
        for _ in range(rounds):
            gb = b0 + 0.5 * _quad_latent(e, _z_update(e, p, h, u))
            u = a / gb
    c = _z_update(e, p, h, u)
    j11, j12, j22, det = c["j11"], c["j12"], c["j22"], c["det"]
    s11, s12, s22, mu1, mu2 = c["s11"], c["s12"], c["s22"], c["mu1"], c["mu2"]
    ht1, ht2 = c["ht1"], c["ht2"]
    logdet_j = torch.log(det)
    if smm:
        qf = _quad_latent(e, c)
        log_gb = torch.log(gb)
        e_log_u = psi_a - log_gb
        u_free = (log_pu_const + (a0 - 1.0) * e_log_u - b0 * u
                  + a - log_gb + math.lgamma(a) + (1.0 - a) * psi_a)
        log_rho = (e["log_pi"] + e_log_u - _LOG_2PI + 0.5 * e["logdet"] - 0.5 * u * e["quad"]
                   + 0.5 * (mu1 * ht1 + mu2 * ht2) - 0.5 * logdet_j + u_free)
    else:
        log_rho = (e["log_pi"] + 0.5 * e["logdet"] - 0.5 * e["quad"]
                   + 0.5 * (mu1 * ht1 + mu2 * ht2) - 0.5 * logdet_j)
    log_resp = log_rho - torch.logsumexp(log_rho, dim=1, keepdim=True)
    resp = torch.exp(log_resp)

    # z = μ̃ + L̃⁻ᵀε, L̃ = chol(J̃).
    l11 = torch.sqrt(j11)
    l21 = j12 / l11
    l22 = torch.sqrt(j22 - l21 * l21)
    u2 = eps[..., 1] / l22
    u1 = (eps[..., 0] - l21 * u2) / l11
    z = torch.stack([mu1 + u1, mu2 + u2], dim=-1)  # (S, N, K, 2)

    # Gaussian decoder over S·N·K rows.
    a1, a2, o = mlp3_fwd(dec, z)
    va = F.softplus(o[..., 2]) + _VAR_FLOOR
    vb = F.softplus(o[..., 3]) + _VAR_FLOOR
    da = x[None, :, None, 0] - o[..., 0]
    db = x[None, :, None, 1] - o[..., 1]
    ll = -0.5 * (torch.log(va) + da * da / va + torch.log(vb) + db * db / vb
                 + 2.0 * _LOG_2PI)
    recon = (resp * ll.sum(0)).sum() / s

    # Local term Σ r̃·a_nk: a_nk = log r̃ − A_nk (SMM: A the per-component
    # free energy) or the closed-form local KL's log q − log p̄ (GMM).
    if smm:
        free_energy = (e["log_pi"] + e_log_u - _LOG_2PI + 0.5 * e["logdet"] - 0.5 * u * qf
                       + (1.0 + _LOG_2PI) - 0.5 * logdet_j + u_free)
        a_nk = log_resp - free_energy
    else:
        g_k = 0.5 * e["logdet"] - _LOG_2PI - 0.5 * e["quad"]
        cross = e["pm1"] * mu1 + e["pm2"] * mu2
        tr = e["prec11"] * s11 + 2.0 * e["prec12"] * s12 + e["prec22"] * s22
        qmu = (e["prec11"] * mu1 * mu1 + 2.0 * e["prec12"] * mu1 * mu2
               + e["prec22"] * mu2 * mu2)
        e_log_pbar = e["log_pi"] + g_k + cross - 0.5 * (tr + qmu)
        a_nk = log_resp - (1.0 + _LOG_2PI) + 0.5 * logdet_j - e_log_pbar
    local = (resp * a_nk).sum()
    neg_loss = -(recon - local) / n

    # ---- backward: neg_loss = −(recon − local)/N
    rbar, lbar = -1.0 / n, 1.0 / n
    llbar = rbar * resp / s  # (N, K), broadcast over S
    obar = torch.stack([
        llbar * da / va,
        llbar * db / vb,
        llbar * (-0.5) * (1.0 / va - da * da / (va * va)) * torch.sigmoid(o[..., 2]),
        llbar * (-0.5) * (1.0 / vb - db * db / (vb * vb)) * torch.sigmoid(o[..., 3]),
    ], dim=-1)
    dec_grads, zbar = mlp3_bwd(dec, z, a1, a2, obar)
    zbar = zbar.reshape(z.shape)

    # Sampling backward through u = L̃⁻ᵀε and the 2×2 Cholesky.
    u1bar = zbar[..., 0]
    u2bar = zbar[..., 1] - u1bar * l21 / l11
    mu1bar = zbar[..., 0].sum(0)
    mu2bar = zbar[..., 1].sum(0)
    l11bar = -(u1bar * u1).sum(0) / l11
    l21bar = -(u1bar * u2).sum(0) / l11
    l22bar = -(u2bar * u2).sum(0) / l22
    j22bar_s = l22bar / (2.0 * l22)
    l21bar = l21bar - l22bar * l21 / l22
    j12bar_s = l21bar / l11
    l11bar = l11bar - l21bar * l21 / l11
    j11bar_s = l11bar / (2.0 * l11)

    # Softmax: r̃ feeds the recon weights and the local term.
    respbar = rbar * ll.sum(0) / s + lbar * a_nk
    lrbar = lbar * resp + respbar * resp
    rhobar = lrbar - resp * lrbar.sum(1, keepdim=True)

    # Local term and log ρ through μ̃, Σ̃, log|J̃|. The GMM's −½(tr + μ̃ᵀJμ̃)
    # + h̄ᵀμ̃ is the SMM's −½ū·Q_f, so the SMM scales those cotangents by ū.
    w = lbar * resp
    uw = u * w
    mu1bar = mu1bar + uw * (-e["pm1"] + e["prec11"] * mu1 + e["prec12"] * mu2)
    mu2bar = mu2bar + uw * (-e["pm2"] + e["prec12"] * mu1 + e["prec22"] * mu2)
    mu1bar = mu1bar + 0.5 * rhobar * ht1
    mu2bar = mu2bar + 0.5 * rhobar * ht2
    j11bar, j12bar, j22bar, ht1bar, ht2bar = _combine_bwd(
        c, mu1bar, mu2bar, 0.5 * uw * e["prec11"], uw * e["prec12"],
        0.5 * uw * e["prec22"], 0.5 * w - 0.5 * rhobar)
    ht1bar = ht1bar + 0.5 * rhobar * mu1
    ht2bar = ht2bar + 0.5 * rhobar * mu2
    j11bar = j11bar + j11bar_s
    j12bar = j12bar + j12bar_s
    j22bar = j22bar + j22bar_s
    p1bar, p2bar = j11bar.sum(1), j22bar.sum(1)
    h1bar, h2bar = ht1bar.sum(1), ht2bar.sum(1)

    if smm and not smm_envelope_grads:
        # ū and b = a/ū of the final update: log ρ and A each carry
        # −(a/b)·log b terms, −½ū·E[μᵀΛμ] (log ρ), −½ū·Q_f (A), −b₀ū (both).
        ubar = (-rhobar * (0.5 * e["quad"] + b0) + w * (0.5 * qf + b0)
                + _u_bar(e, j11bar, j12bar, j22bar, ht1bar, ht2bar))
        bbar = -(rhobar - w) * a / gb - ubar * a / (gb * gb)
        for r in reversed(range(rounds)):
            ur = torch.ones_like(u)
            for _ in range(r):  # ū_r, recomputed from ū = 1
                ur = a / (b0 + 0.5 * _quad_latent(e, _z_update(e, p, h, ur)))
            cr = _z_update(e, p, h, ur)
            qbar = 0.5 * bbar
            jb11, jb12, jb22, hb1, hb2 = _combine_bwd(
                cr,
                2.0 * qbar * (e["prec11"] * cr["mu1"] + e["prec12"] * cr["mu2"] - e["pm1"]),
                2.0 * qbar * (e["prec12"] * cr["mu1"] + e["prec22"] * cr["mu2"] - e["pm2"]),
                qbar * e["prec11"], 2.0 * qbar * e["prec12"], qbar * e["prec22"], 0.0)
            p1bar, p2bar = p1bar + jb11.sum(1), p2bar + jb22.sum(1)
            h1bar, h2bar = h1bar + hb1.sum(1), h2bar + hb2.sum(1)
            if r > 0:  # ū_r = a/b_{r−1}
                bbar = -_u_bar(e, jb11, jb12, jb22, hb1, hb2) * ur * ur / a

    # Encoder head, then the encoder MLP.
    pbar = torch.stack([p1bar, p2bar], dim=-1)
    hbar = torch.stack([h1bar, h2bar], dim=-1)
    meanbar = hbar * p
    varbar = -(pbar + hbar * mean) * p * p
    rawbar = varbar * torch.sigmoid(raw)
    enc_grads, _ = mlp3_bwd(enc, x, a1e, a2e, torch.cat([meanbar, rawbar], -1))

    ru = resp * u
    aux = dict(
        recon=recon, local_kl=local, neg_loss=neg_loss,
        counts=resp.sum(0), u_counts=ru.sum(0),
        s1_1=(ru * mu1).sum(0), s1_2=(ru * mu2).sum(0),
        s2_11=(ru * (s11 + mu1 * mu1)).sum(0),
        s2_12=(ru * (s12 + mu1 * mu2)).sum(0),
        s2_22=(ru * (s22 + mu2 * mu2)).sum(0),
    )
    return {"encoder": enc_grads, "decoder": dec_grads}, aux


# ------------------------------------------------------------- the wrapper


_LAYER_ORDER = ("encoder", "decoder")


def flat_params(tree: dict) -> torch.Tensor:
    """nn_params-layout tree → the kernel's flat f32 buffer (per side, per
    layer: w (in, out) row-major, then b)."""
    return torch.cat([
        t.reshape(-1) for side in _LAYER_ORDER for ly in tree[side]
        for t in (ly["w"], ly["b"])
    ])


def unflat_params(buf: torch.Tensor, like: dict) -> dict:
    out, off = {}, 0
    for side in _LAYER_ORDER:
        out[side] = []
        for ly in like[side]:
            new = {}
            for name in ("w", "b"):
                size = ly[name].numel()
                new[name] = buf[off:off + size].view(ly[name].shape)
                off += size
            out[side].append(new)
    return out


def pack_nat(nat: GmmNat) -> torch.Tensor:
    """GmmNat → (K, 9) block: dir, η₁(2), η₂, η₃(2×2 row-major), η₄."""
    k = nat.dir_nat.shape[0]
    eta1, eta2, eta3, eta4 = nat.niw_nat
    return torch.cat([nat.dir_nat[:, None], eta1, eta2[:, None],
                      eta3.reshape(k, 4), eta4[:, None]], dim=1).contiguous()


def unpack_nat(block: torch.Tensor) -> GmmNat:
    k = block.shape[0]
    return GmmNat(
        dir_nat=block[:, 0],
        niw_nat=NiwNat(eta1=block[:, 1:3], eta2=block[:, 3],
                       eta3=block[:, 4:8].reshape(k, 2, 2), eta4=block[:, 8]),
    )


def shape_class_reason(state: SvaeTrainState, prior: GmmNat, x: torch.Tensor,
                       num_samples: int) -> str | None:
    """Why the CUDA kernel cannot take these shapes (None = it can)."""
    enc, dec = state.nn_params["encoder"], state.nn_params["decoder"]
    if len(enc) != 3 or len(dec) != 3:
        return "the kernel runs two-hidden-layer MLPs only"
    hid_e = (enc[0]["w"].shape[1], enc[1]["w"].shape[1])
    hid_d = (dec[0]["w"].shape[1], dec[1]["w"].shape[1])
    if hid_e != hid_d or hid_e not in SUPPORTED_HIDDEN:
        return (f"hidden widths enc {hid_e} / dec {hid_d}: the kernel is "
                f"built for matched widths in {SUPPORTED_HIDDEN}")
    if x.ndim != 2 or x.shape[1] != 2 or enc[0]["w"].shape[0] != 2:
        return "the kernel takes 2-D data"
    if dec[0]["w"].shape[0] != 2 or enc[2]["w"].shape[1] != 4:
        return "the kernel takes latent d = 2 with a diagonal head"
    if dec[2]["w"].shape[1] != 4:
        return "the kernel takes a Gaussian decoder head"
    k = prior.dir_nat.shape[0]
    if not 1 <= k <= MAX_COMPONENTS:
        return f"K = {k} outside 1..{MAX_COMPONENTS}"
    if num_samples < 1:
        return "num_samples must be >= 1"
    if 2 * num_samples * x.shape[0] * k >= 2**32:
        return "S·N·K·2 normals per step overflow the Philox counter"
    return None


def train_chunk(state: SvaeTrainState, prior: GmmNat, x: torch.Tensor, *,
                lr: float, rho: float, t_steps: int, seed: int = 0,
                aug_noise: float = 0.0, num_samples: int = 4,
                eps: torch.Tensor | None = None,
                aug_eps: torch.Tensor | None = None,
                dof: float = 0.0, smm_iters: int = 2,
                smm_envelope_grads: bool = False):
    """Run T complete train steps; returns (state, {"recon", "local_kl",
    "neg_loss"} of shape (T,)).

    Semantics of T iterations of ``svae_step.make_train_step`` (full
    batch, constant ρ) with ``augment_step(σ=aug_noise)``: the GMM prior
    for ``dof`` = 0, else the SMM prior (``svae_smm``, ``smm_iters``
    u–z rounds, ``smm_envelope_grads``), whose Gamma constants the host
    computes. ``elbo`` needs the global KL, added outside
    (``loop.make_runner``).

    CUDA tensors: one launch of the CUDA kernel; f32, contiguous, one
    device, the kernel's shape class — anything else raises. The state is
    packed into fresh flat device buffers that the kernel updates in
    place; the returned state's tensors are views of those buffers, and
    the input state is not modified. CPU tensors: ``train_chunk_plain``.
    """
    global launches
    if x.device.type == "cpu":
        return train_chunk_plain(
            state, prior, x, lr=lr, rho=rho, t_steps=t_steps,
            num_samples=num_samples, seed=seed, aug_noise=aug_noise, eps=eps,
            aug_eps=aug_eps, dof=dof, smm_iters=smm_iters,
            smm_envelope_grads=smm_envelope_grads,
        )
    if x.device.type != "cuda":
        raise ValueError(f"tinystep.train_chunk: no kernel for device {x.device}")
    if aug_noise > 0.0 and (eps is None) != (aug_eps is None):
        raise ValueError("aug_noise > 0 with injected noise needs both eps "
                         "and aug_eps (or neither)")
    s = eps.shape[1] if eps is not None else num_samples
    reason = shape_class_reason(state, prior, x, s)
    if reason is not None:
        raise ValueError(f"tinystep.train_chunk: {reason}")
    n, k = x.shape[0], prior.dir_nat.shape[0]
    h1, h2 = state.nn_params["encoder"][0]["w"].shape[1], (
        state.nn_params["encoder"][1]["w"].shape[1])
    tensors = [x, *prior.niw_nat, prior.dir_nat, *state.pgm_nat.niw_nat,
               state.pgm_nat.dir_nat]
    for tree in (state.nn_params, state.opt_state.mu, state.opt_state.nu):
        tensors += [t for side in tree.values() for ly in side for t in ly.values()]
    if eps is not None:
        tensors.append(eps)
        if eps.shape != (t_steps, s, n, k, 2):
            raise ValueError(f"eps shape {tuple(eps.shape)} != "
                             f"{(t_steps, s, n, k, 2)}")
    if aug_eps is not None and aug_noise > 0.0:
        tensors.append(aug_eps)
        if aug_eps.shape != (t_steps, n, 2):
            raise ValueError(f"aug_eps shape {tuple(aug_eps.shape)} != "
                             f"{(t_steps, n, 2)}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("tinystep.train_chunk: every tensor must be "
                             f"float32 on {x.device} (got {t.dtype} on {t.device})")
    for t in (x, eps, aug_eps):
        if t is not None and not t.is_contiguous():
            raise ValueError("tinystep.train_chunk: x, eps and aug_eps must "
                             "be contiguous")

    from svax_torch.ops import _build

    ptr = _build.ptr

    lib = _build.load()
    params = flat_params(state.nn_params)
    m = flat_params(state.opt_state.mu)
    v = flat_params(state.opt_state.nu)
    nat = pack_nat(state.pgm_nat)
    prior_b = pack_nat(prior)
    metrics = torch.empty((t_steps, 3), device=x.device, dtype=torch.float32)
    scratch = torch.empty(lib.tinystep_scratch_floats(n, k, s, h1, h2),
                          device=x.device, dtype=torch.float32)
    aug_in = aug_eps if aug_noise > 0.0 else None
    psi_a = k_u = 0.0
    if dof > 0.0:
        _, a, log_pu_const, psi_a = svae_smm.gamma_constants(dof, 2)
        k_u = log_pu_const + a + math.lgamma(a) + (1.0 - a) * psi_a
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.tinystep_train_chunk(
            ptr(x), n, k, s, h1, h2,
            ptr(prior_b), ptr(nat), ptr(params), ptr(m), ptr(v),
            ptr(metrics), ptr(scratch), ptr(eps), ptr(aug_in),
            t_steps, state.opt_state.count,
            (seed + state.step) & 0xFFFFFFFFFFFFFFFF,
            float(lr), float(rho), float(aug_noise),
            float(max(dof, 0.0)), int(smm_iters), int(bool(smm_envelope_grads)),
            float(psi_a), float(k_u), ctypes.c_void_p(stream),
        )
    _build.check(lib, err, "tinystep_train_chunk")
    launches += 1
    new_state = SvaeTrainState(
        nn_params=unflat_params(params, state.nn_params),
        opt_state=AdamState(count=state.opt_state.count + t_steps,
                            mu=unflat_params(m, state.nn_params),
                            nu=unflat_params(v, state.nn_params)),
        pgm_nat=unpack_nat(nat),
        step=state.step + t_steps,
    )
    return new_state, {"recon": metrics[:, 0], "local_kl": metrics[:, 1],
                       "neg_loss": metrics[:, 2]}
