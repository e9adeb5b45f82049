"""Whole-train-step kernel for the small-d minibatch SVAE (auto-svae):
wrapper, plain version, hand-derived backward.

Port of ``svax/ops/flexstep_pallas.py``. ``train_chunk`` runs T complete
training steps, one per row of a pre-gathered (T, M, d_in) batch stack —
encoder, general-d SIN combine (Cholesky of J̃ = diag(Pₙ) + E[Λ_k], μ̃,
log|J̃|, softmax over K), S reparameterised samples per (n, k), Gaussian
decoder over K·S·M rows, local KL, CVI statistics, backward, Adam, and
CVI with ρ_t = ρ₀/(1 + decay·t) — in ONE launch of the CUDA kernel in
``csrc/flexstep.cu`` (its combine math in ``csrc/combine_tile.cuh``): one
thread-block cluster of ``cluster`` CTAs (``csrc/cluster_step.cuh``), each
owning a contiguous range of the minibatch rows (``cluster_plan``).

* On CUDA tensors it launches the kernel, or raises; there is no fallback.
* On CPU tensors it runs ``train_chunk_plain``: T iterations of
  ``svae_step.make_train_step`` over the batch stack.
* ``step_grads_manual`` is the backward written out by hand in plain
  PyTorch — the formulas the kernel transcribes, tested on the CPU
  against autograd — and ``expected_slots`` the kernel's expected-
  parameter map (ψ by the recurrence the kernel uses).

Precision (``nn_precision``): "highest" and "high" run every MLP product
in f32; "default" is the bf16-product mode of ``ops.tinystep`` (every
product of ``gemm`` and ``weight_grads`` on bf16-rounded operands with f32
FMAs and sums, the weights rounded once a step into the shared copy, the
biases' sums f32), instantiated at the default cluster size only; its
plain version is the plain step at ``nn_precision="default"``.

Noise: ``eps`` (T, S, M, K, d) injects it (the parity mode); otherwise
the kernel draws it from an in-kernel Philox4x32-10 + Box–Muller keyed by
``seed + state.step``, normal ((s·M + n)·K + k)·d + i of stream t.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from svax_torch.expfam.niw import NiwNat
from svax_torch.models.svae import SvaeConfig
from svax_torch.ops.tinystep import (CLUSTER_SIZES, SMEM_LIMIT, bf16_mode, digamma,
                                     flat_params, mlp3_bwd, mlp3_fwd, pad_to, part_begin,
                                     unflat_params)
from svax_torch.pgm import gmm
from svax_torch.pgm.gmm import GmmNat
from svax_torch.train import svae_step
from svax_torch.train.svae_step import AdamState, SvaeTrainState

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
_VAR_FLOOR = 1e-6

# The kernel's shape class (flexstep_pallas.supported, plus what its shared
# memory holds): latent d is a template parameter, the rest runtime sizes.
LATENT_DIMS = (2, 3, 4, 5, 6)
MAX_INPUT = 8
MAX_HIDDEN = 128
MAX_COMPONENTS = 64
# The cluster size the wrapper launches unless told otherwise (the faster
# on the H100, PERF.md); CLUSTER_SIZES are those instantiated.
DEFAULT_CLUSTER = 16

launches = 0  # f32-mode kernel launches made by train_chunk (plain int)
launches_bf16 = 0  # bf16-product-mode launches


# ------------------------------------------------------------ plain version


def train_chunk_plain(state: SvaeTrainState, prior: GmmNat, batches: torch.Tensor,
                      *, lr: float, rho: float, rho_decay: float = 0.0,
                      num_total: int, num_samples: int = 4, seed: int = 0,
                      eps: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      nn_precision: str = "highest"):
    """T iterations of make_train_step, one per row of ``batches``, the nets
    at ``nn_precision``.

    Returns (state, {"recon", "local_kl", "neg_loss", "rho"} of shape (T,)).
    Without injected noise it draws from ``generator``, or from one on
    ``batches.device`` seeded ``seed + state.step``: the same distribution
    as the kernel's Philox stream, not the same numbers.
    """
    t_steps, _, _ = batches.shape
    k, d = prior.niw_nat.eta1.shape
    s = eps.shape[1] if eps is not None else num_samples
    bf16_mode(nn_precision)
    config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s,
                        num_total=num_total, nn_precision=nn_precision)
    step = svae_step.make_train_step(config, prior, lr,
                                     svae_step.rho_schedule(rho, rho_decay))
    if eps is None and generator is None:
        generator = torch.Generator(device=batches.device).manual_seed(seed + state.step)
    mets = {"recon": [], "local_kl": [], "neg_loss": [], "rho": []}
    for t in range(t_steps):
        state, m = step(state, batches[t], eps=None if eps is None else eps[t],
                        generator=generator)
        for name in mets:
            mets[name].append(m[name])
    return state, {name: torch.stack(v) for name, v in mets.items()}


# ------------------------------------------------------ hand-written backward


def expected_slots(nat: GmmNat) -> torch.Tensor:
    """Expected GMM params as the kernel computes them, (K, 3 + d + d²):
    [E[log π], E[log|Λ|], E[μᵀΛμ], E[Λμ] (d), E[Λ] (d×d row-major)] — the
    slot row of combine_pallas's w block (flexstep_pallas._expected_w_block),
    with ψ by the kernel's recurrence."""
    k, d = nat.niw_nat.eta1.shape
    alpha = nat.dir_nat + 1.0
    log_pi = digamma(alpha) - digamma(alpha.sum())
    eta1, kappa, eta3, eta4 = nat.niw_nat
    m = eta1 / kappa[:, None]
    phi = eta3 - kappa[:, None, None] * m[:, :, None] * m[:, None, :]
    nu = eta4 - (d + 2.0)
    chol = torch.linalg.cholesky(phi)
    inv_phi = torch.cholesky_inverse(chol)
    pim = (inv_phi @ m[:, :, None])[..., 0]
    quad = d / kappa + nu * (m * pim).sum(-1)
    logdet = (sum(digamma((nu - i) / 2.0) for i in range(d)) + d * _LOG_2
              - 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1))
    return torch.cat([log_pi[:, None], logdet[:, None], quad[:, None],
                      nu[:, None] * pim, (nu[:, None, None] * inv_phi).reshape(k, d * d)],
                     dim=1)


def _tril_half(a: torch.Tensor) -> torch.Tensor:
    """Φ(A): the lower triangle of A with its diagonal halved (Murray 2016)."""
    return torch.tril(a) - 0.5 * torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))


def step_grads_manual(nn_params: dict, nat: GmmNat, x: torch.Tensor,
                      eps: torch.Tensor, num_total: int | None = None):
    """One step's forward and its backward, written out by hand, general d.

    x (M, d_in) is the minibatch, eps (S, M, K, d). Returns (grads of
    neg_loss = −(recon − local_kl)/num_total in the nn_params layout, aux
    dict with recon, local_kl, neg_loss and the scaled (K,) counts, (K, d)
    s1 and (K, d, d) s2 statistics). ``num_total`` defaults to M.

    Per (n, k), with J̃ = L̃L̃ᵀ, Σ̃ = J̃⁻¹ and only diag(J̃) = Pₙ + diag E[Λ_k]
    and h̃ = hₙ + E[Λμ]_k depending on the encoder:
      d log|J̃| = tr(Σ̃ dJ̃),  dμ̃ = Σ̃(dh̃ − dJ̃ μ̃),  dΣ̃ = −Σ̃ dJ̃ Σ̃,
    and for u = L̃⁻ᵀε the Cholesky backward of L̄ = −tril(Σ_s u_s (L̃⁻¹ū_s)ᵀ):
      J̄ ⊇ L̃⁻ᵀ Φ(L̃ᵀL̄) L̃⁻¹ (Murray 2016), of which only the diagonal is needed.
    """
    enc, dec = nn_params["encoder"], nn_params["decoder"]
    s, m, k, d = eps.shape
    d_in = x.shape[1]
    num_total = m if num_total is None else num_total
    scale = num_total / m
    ex = gmm.expected_params(nat)
    prec, pm = ex.prec[None], ex.prec_mean[None]  # (1, K, d, d), (1, K, d)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    # Encoder → diagonal potential.
    a1e, a2e, out = mlp3_fwd(enc, x)
    mean, raw = out[:, :d], out[:, d:]
    p = 1.0 / (F.softplus(raw) + _VAR_FLOOR)
    h = mean * p

    # Combine on (M, K) batches of d×d blocks.
    jt = prec + torch.diag_embed(p)[:, None]
    ht = pm + h[:, None]
    chol = torch.linalg.cholesky(jt)
    li = torch.linalg.solve_triangular(chol, eye.expand_as(jt), upper=False)  # L̃⁻¹
    cov = li.mT @ li
    mu = (cov @ ht[..., None])[..., 0]
    logdet_j = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    log_rho = (ex.log_pi + 0.5 * ex.logdet - 0.5 * ex.quad
               + 0.5 * (mu * ht).sum(-1) - 0.5 * logdet_j)
    log_resp = torch.log_softmax(log_rho, dim=-1)
    resp = torch.exp(log_resp)

    # z = μ̃ + L̃⁻ᵀε.
    u = (li.mT @ eps[..., None])[..., 0]  # (S, M, K, d)
    z = mu + u

    # Gaussian decoder over S·M·K rows.
    a1, a2, o = mlp3_fwd(dec, z)
    xm, xr = o[..., :d_in], o[..., d_in:]
    var = F.softplus(xr) + _VAR_FLOOR
    diff = x[None, :, None, :] - xm
    ll = -0.5 * (torch.log(var) + diff * diff / var + _LOG_2PI).sum(-1)  # (S, M, K)
    recon = scale * (resp * ll.sum(0)).sum() / s

    # Local KL, closed form.
    g_k = 0.5 * ex.logdet - 0.5 * d * _LOG_2PI - 0.5 * ex.quad
    prec_mu = (prec @ mu[..., None])[..., 0]
    e_log_pbar = (ex.log_pi + g_k + (pm * mu).sum(-1)
                  - 0.5 * ((prec * cov).sum((-2, -1)) + (mu * prec_mu).sum(-1)))
    a_nk = log_resp - 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * logdet_j - e_log_pbar
    local = scale * (resp * a_nk).sum()
    neg_loss = -(recon - local) / num_total

    # ---- backward
    rbar, lbar = -scale / num_total, scale / num_total
    llbar = (rbar * resp / s)[None, ..., None]
    obar = torch.cat([llbar * diff / var,
                      llbar * (-0.5) * (1.0 / var - diff * diff / (var * var))
                      * torch.sigmoid(xr)], dim=-1)
    dec_grads, zbar = mlp3_bwd(dec, z, a1, a2, obar)
    zbar = zbar.reshape(z.shape)

    # Sampling: μ̃ gets Σ_s z̄; L̃ gets −tril(Σ_s u vᵀ), v = L̃⁻¹ z̄.
    v = (li @ zbar[..., None])[..., 0]
    lbar_chol = -torch.tril((u[..., :, None] * v[..., None, :]).sum(0))

    # Softmax: r̃ feeds the recon weights and the local KL.
    respbar = rbar * ll.sum(0) / s + lbar * a_nk
    lrbar = lbar * resp + respbar * resp
    rhobar = lrbar - resp * lrbar.sum(-1, keepdim=True)

    # Local KL and log ρ through μ̃, Σ̃, log|J̃|, then J̃ and h̃.
    w = lbar * resp
    mubar = zbar.sum(0) + w[..., None] * (prec_mu - pm) + 0.5 * rhobar[..., None] * ht
    ldbar = 0.5 * w - 0.5 * rhobar
    cmb = (cov @ mubar[..., None])[..., 0]
    htbar = cmb + 0.5 * rhobar[..., None] * mu
    diag = lambda a: torch.diagonal(a, dim1=-2, dim2=-1)  # noqa: E731
    jbar = (ldbar[..., None] * diag(cov) - 0.5 * w[..., None] * diag(cov @ prec @ cov)
            - cmb * mu + diag(li.mT @ _tril_half(chol.mT @ lbar_chol) @ li))

    # Encoder head, then the encoder MLP.
    pbar, hbar = jbar.sum(1), htbar.sum(1)
    meanbar = hbar * p
    rawbar = -(pbar + hbar * mean) * p * p * torch.sigmoid(raw)
    enc_grads, _ = mlp3_bwd(enc, x, a1e, a2e, torch.cat([meanbar, rawbar], -1))

    ezz = cov + mu[..., :, None] * mu[..., None, :]
    aux = dict(
        recon=recon, local_kl=local, neg_loss=neg_loss,
        counts=scale * resp.sum(0),
        s1=scale * (resp[..., None] * mu).sum(0),
        s2=scale * (resp[..., None, None] * ezz).sum(0),
    )
    return {"encoder": enc_grads, "decoder": dec_grads}, aux


# ------------------------------------------------------------- the wrapper


def pack_nat(nat: GmmNat) -> torch.Tensor:
    """GmmNat → (K, 3 + d + d²) block: dir, η₁ (d), η₂, η₃ (d×d row-major), η₄."""
    k, d = nat.niw_nat.eta1.shape
    eta1, eta2, eta3, eta4 = nat.niw_nat
    return torch.cat([nat.dir_nat[:, None], eta1, eta2[:, None],
                      eta3.reshape(k, d * d), eta4[:, None]], dim=1).contiguous()


def unpack_nat(block: torch.Tensor, d: int) -> GmmNat:
    k = block.shape[0]
    return GmmNat(
        dir_nat=block[:, 0],
        niw_nat=NiwNat(eta1=block[:, 1:1 + d], eta2=block[:, 1 + d],
                       eta3=block[:, 2 + d:2 + d + d * d].reshape(k, d, d),
                       eta4=block[:, 2 + d + d * d]),
    )


def unsupported_reason(nn_params: dict, prior: GmmNat, batch_shape,
                       num_samples: int) -> str | None:
    """Why the CUDA kernel cannot take these shapes (None = it can).

    The shape class of flexstep_pallas.supported: a Gaussian likelihood
    (decoder output 2·d_in), a diagonal head (encoder output 2d), two tanh
    hidden layers a side, d_in ≤ 8 and 2 ≤ d ≤ 6; plus what the kernel's
    shared memory holds: hidden widths ≤ MAX_HIDDEN, K ≤ MAX_COMPONENTS."""
    enc, dec = nn_params["encoder"], nn_params["decoder"]
    if len(enc) != 3 or len(dec) != 3:
        return "the kernel runs two-hidden-layer MLPs only"
    _, m, d_in = batch_shape
    k, d = prior.niw_nat.eta1.shape
    if d not in LATENT_DIMS:
        return f"latent d = {d} outside {LATENT_DIMS[0]}..{LATENT_DIMS[-1]}"
    if not 1 <= d_in <= MAX_INPUT or enc[0]["w"].shape[0] != d_in:
        return f"d_in = {d_in}: the kernel takes data of width 1..{MAX_INPUT}"
    if enc[2]["w"].shape[1] != 2 * d or dec[0]["w"].shape[0] != d:
        return "the kernel takes a diagonal recognition head (encoder output 2d)"
    if dec[2]["w"].shape[1] != 2 * d_in:
        return "the kernel takes a Gaussian decoder head (output 2·d_in)"
    widths = [ly["w"].shape[1] for ly in (enc[0], enc[1], dec[0], dec[1])]
    if not all(1 <= w <= MAX_HIDDEN for w in widths):
        return f"hidden widths {widths}: the kernel takes 1..{MAX_HIDDEN}"
    if not 1 <= k <= MAX_COMPONENTS:
        return f"K = {k} outside 1..{MAX_COMPONENTS}"
    if num_samples < 1 or m < 1:
        return "num_samples and the batch size must be >= 1"
    if num_samples * m * k * d >= 2**32:
        return "S·M·K·d normals per step overflow the Philox counter"
    return None


def cluster_plan(m: int, k: int, s: int, n_params: int, cluster: int) -> list[dict]:
    """What each CTA of the cluster owns, as the kernel cuts it: per rank r,
    its minibatch rows, its (n, k) records (n·K + k), its decoder rows in
    the kernel's order ((n·K + k)·S + s: one range) and its slice of the
    flat parameters."""
    plan = []
    for r in range(cluster):
        m0, m1 = part_begin(m, cluster, r), part_begin(m, cluster, r + 1)
        plan.append({
            "points": range(m0, m1),
            "records": range(m0 * k, m1 * k),
            "rows": [range(m0 * k * s, m1 * k * s)],
            "params": range(part_begin(n_params, cluster, r),
                            part_begin(n_params, cluster, r + 1)),
        })
    return plan


def n_params(d_in: int, d: int, h1e: int, h2e: int, h1d: int, h2d: int) -> int:
    """Size of the flat parameter vector (both sides, W then b per layer)."""
    enc = d_in * h1e + h1e + h1e * h2e + h2e + h2e * 2 * d + 2 * d
    dec = d * h1d + h1d + h1d * h2d + h2d + h2d * 2 * d_in + 2 * d_in
    return enc + dec


def smem_bytes(d_in: int, d: int, k: int, h1e: int, h2e: int, h1d: int, h2d: int,
               cluster: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one CTA (csrc/flexstep.cu: Smem): the
    parameters, this CTA's slice of both Adam moments (and, in the
    bf16-product mode, of the f32 parameters), the naturals and the
    expected parameters (K rows of 3 + d + d²), and the cluster totals of
    the statistics (K·(1 + d + d²)), recon and local."""
    p = n_params(d_in, d, h1e, h2e, h1d, h2d)
    f = 3 + d + d * d
    floats = (pad_to(p, 4) + (3 if bf16 else 2) * pad_to(-(-p // cluster), 4)
              + 2 * pad_to(k * f, 4)
              + pad_to(k * (1 + d + d * d) + 2, 4))
    return 4 * floats


def train_chunk(state: SvaeTrainState, prior: GmmNat, batches: torch.Tensor, *,
                lr: float, rho: float, rho_decay: float = 0.0, num_total: int,
                num_samples: int = 4, seed: int = 0,
                eps: torch.Tensor | None = None, cluster: int | None = None,
                nn_precision: str = "highest"):
    """Run T complete train steps, one per row of the (T, M, d_in) stack;
    returns (state, {"recon", "local_kl", "neg_loss", "rho"} of shape (T,)).

    Semantics of T iterations of ``svae_step.make_train_step`` (GMM prior)
    with ρ_t = rho/(1 + rho_decay·t) at the pre-update step t and the
    statistics scaled by num_total/M. ``elbo`` needs the global KL, added
    outside (``loop.make_runner``). ``nn_precision="default"`` runs the
    bf16-product mode (module docstring), at ``DEFAULT_CLUSTER`` only.

    CUDA tensors: one launch of the CUDA kernel as one cluster of
    ``cluster`` CTAs (``CLUSTER_SIZES``; ``DEFAULT_CLUSTER`` when None); f32,
    contiguous, one device, the kernel's shape class — anything else
    raises, as does a card with no room for the cluster. The returned
    state's tensors are views of fresh flat buffers that the kernel
    updated in place; the input state is not modified. CPU tensors:
    ``train_chunk_plain``.
    """
    global launches, launches_bf16
    if batches.device.type == "cpu":
        return train_chunk_plain(
            state, prior, batches, lr=lr, rho=rho, rho_decay=rho_decay,
            num_total=num_total, num_samples=num_samples, seed=seed, eps=eps,
            nn_precision=nn_precision)
    bf16 = bf16_mode(nn_precision)
    if batches.device.type != "cuda":
        raise ValueError(f"flexstep.train_chunk: no kernel for device {batches.device}")
    if batches.ndim != 3:
        raise ValueError(f"flexstep.train_chunk: batches must be (T, M, d_in), "
                         f"got {tuple(batches.shape)}")
    t_steps, m, d_in = batches.shape
    k, d = prior.niw_nat.eta1.shape
    s = eps.shape[1] if eps is not None else num_samples
    reason = unsupported_reason(state.nn_params, prior, batches.shape, s)
    if reason is not None:
        raise ValueError(f"flexstep.train_chunk: {reason}")
    cluster = DEFAULT_CLUSTER if cluster is None else cluster
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"flexstep.train_chunk: cluster {cluster} not in {CLUSTER_SIZES}")
    if bf16 and cluster != DEFAULT_CLUSTER:
        raise ValueError(f"flexstep.train_chunk: the bf16-product mode runs at cluster "
                         f"{DEFAULT_CLUSTER} only")
    enc, dec = state.nn_params["encoder"], state.nn_params["decoder"]
    h1e, h2e = enc[0]["w"].shape[1], enc[1]["w"].shape[1]
    h1d, h2d = dec[0]["w"].shape[1], dec[1]["w"].shape[1]
    smem = smem_bytes(d_in, d, k, h1e, h2e, h1d, h2d, cluster, bf16)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flexstep.train_chunk: {smem} bytes of shared memory a CTA "
                         f"exceed {SMEM_LIMIT}")
    tensors = [batches, *prior.niw_nat, prior.dir_nat, *state.pgm_nat.niw_nat,
               state.pgm_nat.dir_nat]
    for tree in (state.nn_params, state.opt_state.mu, state.opt_state.nu):
        tensors += [t for side in tree.values() for ly in side for t in ly.values()]
    if eps is not None:
        tensors.append(eps)
        if eps.shape != (t_steps, s, m, k, d):
            raise ValueError(f"eps shape {tuple(eps.shape)} != {(t_steps, s, m, k, d)}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != batches.device:
            raise ValueError("flexstep.train_chunk: every tensor must be float32 on "
                             f"{batches.device} (got {t.dtype} on {t.device})")
    for t in (batches, eps):
        if t is not None and not t.is_contiguous():
            raise ValueError("flexstep.train_chunk: batches and eps must be contiguous")

    from svax_torch.ops import _build

    ptr = _build.ptr

    lib = _build.load()
    params = flat_params(state.nn_params)
    m1 = flat_params(state.opt_state.mu)
    v1 = flat_params(state.opt_state.nu)
    nat = pack_nat(state.pgm_nat)
    prior_b = pack_nat(prior)
    metrics = torch.empty((t_steps, 4), device=batches.device, dtype=torch.float32)
    dims = (m, d_in, d, k, s, h1e, h2e, h1d, h2d)
    scratch = torch.empty(lib.flexstep_scratch_floats(*dims, cluster), device=batches.device,
                          dtype=torch.float32)
    stream = torch.cuda.current_stream(batches.device).cuda_stream
    with torch.cuda.device(batches.device):
        err = lib.flexstep_train_chunk(
            ptr(batches), *dims,
            ptr(prior_b), ptr(nat), ptr(params), ptr(m1), ptr(v1),
            ptr(metrics), ptr(scratch), ptr(eps),
            t_steps, state.opt_state.count, state.step,
            (seed + state.step) & 0xFFFFFFFFFFFFFFFF,
            float(lr), float(rho), float(rho_decay), float(num_total),
            cluster, int(bf16), ctypes.c_void_p(stream),
        )
    _build.check(lib, err, "flexstep_train_chunk")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    new_state = SvaeTrainState(
        nn_params=unflat_params(params, state.nn_params),
        opt_state=AdamState(count=state.opt_state.count + t_steps,
                            mu=unflat_params(m1, state.nn_params),
                            nu=unflat_params(v1, state.nn_params)),
        pgm_nat=unpack_nat(nat, d),
        step=state.step + t_steps,
    )
    return new_state, {"recon": metrics[:, 0], "local_kl": metrics[:, 1],
                       "neg_loss": metrics[:, 2], "rho": metrics[:, 3]}
