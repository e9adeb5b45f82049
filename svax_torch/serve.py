"""Inference / serving layer (``svax/serve.py``): self-describing model
bundles, a bucketed batching server, and its exported tier.

* **Bundles.** ``save_bundle`` writes the trained state (``train.checkpoint``,
  under ``state/``) next to a ``spec.json`` holding the architecture and
  hyperparameters, so ``load_bundle`` rebuilds the model with no flags from
  the caller.
* **Bucketed batching.** Every request is padded up to a fixed bucket
  ladder, so an endpoint sees at most ``len(buckets)`` input shapes (the
  shapes an exported artifact or a captured CUDA graph is made for);
  requests above the top bucket are cut into top-bucket pieces. Every
  endpoint is row-independent, so padding rows are computed and dropped
  without touching real ones. The whole answer leaves the device in one
  copy.
* **CUDA graphs.** On the card each endpoint's body — live, or an exported
  program's ``module()`` — is captured as a CUDA graph per (endpoint,
  bucket, static arguments) at the first request that reaches it
  (``train.graph.CallGraph``; the reference jits each endpoint once per
  bucket shape) and replayed; padding, the host-to-device copy, the cut of
  the padding rows and the one device-to-host copy stay outside the graph.
  ``graph=False`` keeps every operation dispatched from the host;
  ``server.route`` says which route serves.
* **Exported tier.** ``export_serving`` traces every endpoint × bucket with
  ``torch.export`` — the weights become the program's constants — and
  saves it with ``torch.export.save``, so ``load_exported`` serves from the
  artifact directory alone: no model code, no checkpoint, no re-trace.

Endpoints: ``encode`` (structured posterior: latent mean, responsibilities,
hard cluster), ``score`` (importance-weighted log-likelihood per point),
``reconstruct`` (the decoder at the posterior mean), ``impute``
(missing-data fill-in by iterated encode → decode), ``cluster`` and
``generate`` (sample the generative model). GMM- and SMM-prior SVAEs both
serve. The endpoints run the plain PyTorch model (the reference's server
calls no Pallas kernel) under ``torch.inference_mode`` on the server's
device.

Bundles carry the recognition head ("diag" or "full") and the nets'
activation ("tanh", "relu" or "softplus"), as the reference's do; the
posterior takes the full head's (N, d, d) precision in its
``torch.linalg`` route, and the nets run f32 products.

``score`` draws random numbers, which a traced program cannot take from a
``torch.Generator``: its Gumbel and ε draws are inputs of the endpoint,
drawn outside it, in plain torch, from ``torch.Generator(device)
.manual_seed(seed)`` — by both tiers alike, so the live and the exported
score agree bit for bit for one seed.

This module imports the model modules only inside the functions that
build a model (``ModelSpec.to_config``, ``load_bundle``, ``SvaeServer``):
serving from artifacts imports none of them.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from svax_torch.utils.tree import flatten, map_leaves, unflatten

_SPEC_FILE = "spec.json"
_DEFAULT_BUCKETS = (32, 128, 512, 2048, 8192)
_EXPORT_MANIFEST = "exports.json"
_ENDPOINTS = ("encode", "reconstruct", "score", "impute")
# The heads and activations a bundle may name (nets.mlp's, kept here as
# names so that serving from artifacts imports no model module).
_HEADS = ("diag", "full")
_ACTIVATIONS = ("tanh", "relu", "softplus")


@dataclass(frozen=True)
class ModelSpec:
    """Everything needed to rebuild the model skeleton from disk (the
    reference's fields and defaults)."""

    input_dim: int
    latent_dim: int
    num_components: int
    likelihood: str = "gaussian"
    encoder_hidden: tuple = (50, 50)
    decoder_hidden: tuple = (50, 50)
    num_samples: int = 1
    alpha: float = 1.0
    kappa: float = 0.05
    dof: float = 0.0  # > 0 → Student-t (SMM) latent prior
    smm_iters: int = 2
    activation: str = "tanh"
    num_total: int = 1
    encoder_head: str = "diag"  # or "full" (the reference's nets)

    def check_supported(self) -> None:
        """Raise for a head or an activation the nets do not know (the
        reference's: svax/serve.py:52)."""
        if self.encoder_head not in _HEADS:
            raise ValueError(f"encoder_head={self.encoder_head!r}: one of {_HEADS}")
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"activation={self.activation!r}: one of {_ACTIVATIONS}")

    def to_config(self):
        from svax_torch.models.svae import SvaeConfig

        self.check_supported()
        return SvaeConfig(latent_dim=self.latent_dim, num_components=self.num_components,
                          num_samples=self.num_samples, num_total=self.num_total,
                          likelihood=self.likelihood, dof=self.dof,
                          smm_iters=self.smm_iters, activation=self.activation,
                          encoder_head=self.encoder_head)

    def make_prior(self, device="cpu"):
        from svax_torch.pgm import gmm

        return gmm.make_prior(self.num_components, self.latent_dim, alpha=self.alpha,
                              kappa=self.kappa, device=device)


def spec_payload(spec: ModelSpec) -> dict:
    """``spec.json``'s dict: the dataclass's fields, hidden widths as lists."""
    payload = asdict(spec)
    payload["encoder_hidden"] = list(spec.encoder_hidden)
    payload["decoder_hidden"] = list(spec.decoder_hidden)
    return payload


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is available "
                           "(use device='cpu')")
    return device


def save_bundle(directory: str | Path, state, spec: ModelSpec) -> None:
    """Write a self-describing serving bundle: the state under ``state/``
    (its Adam moments ride along, so the bundle stays resumable) and
    ``spec.json``."""
    from svax_torch.train.checkpoint import Checkpointer

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    Checkpointer(directory / "state").save(int(state.step), state)
    (directory / _SPEC_FILE).write_text(json.dumps(spec_payload(spec), indent=2))


def load_bundle(directory: str | Path, buckets=_DEFAULT_BUCKETS,
                device="cuda", graph: bool | str | None = None) -> "SvaeServer":
    """Rebuild a server on ``device`` from ``save_bundle``'s output (``graph``
    as ``SvaeServer``'s); raises for a missing state, a spec the port cannot
    serve, or ``cuda`` without a card."""
    from svax_torch.train import svae_step
    from svax_torch.train.checkpoint import Checkpointer

    device = _device(device)
    directory = Path(directory)
    raw = json.loads((directory / _SPEC_FILE).read_text())
    raw["encoder_hidden"] = tuple(raw["encoder_hidden"])
    raw["decoder_hidden"] = tuple(raw["decoder_hidden"])
    spec = ModelSpec(**raw)
    spec.check_supported()
    ckpt = Checkpointer(directory / "state")
    if ckpt.latest_step() is None:
        raise FileNotFoundError(f"no saved state under {directory / 'state'}")
    template = svae_step.init_state(
        torch.Generator(device=device).manual_seed(0), spec.input_dim, spec.to_config(),
        spec.make_prior(device), spec.encoder_hidden, spec.decoder_hidden)
    state, _, _ = ckpt.restore_or(template)
    return SvaeServer(state.nn_params, state.pgm_nat, spec, buckets=buckets, device=device,
                      graph=graph)


def _rows(x) -> torch.Tensor:
    """A request as an (n, width) float32 tensor (numpy or tensor input)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float32)
    else:
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    return x[None] if x.ndim == 1 else x


def _pack_masked(x, mask) -> torch.Tensor:
    """Pack ``[x | mask]`` on the feature axis (the impute preamble both
    tiers share). The mask is binarised after broadcasting — any truthy
    value means "observed" — so a fractional mask cannot blend the zeroed
    placeholder with the reconstruction, and the missing entries are
    replaced by 0 with ``where`` (a NaN placeholder times 0 would stay NaN)."""
    x = _rows(x)
    mask = mask if isinstance(mask, torch.Tensor) else torch.from_numpy(np.asarray(mask))
    mask = (torch.broadcast_to(mask.to(x.device), x.shape) > 0).to(torch.float32)
    return torch.cat([torch.where(mask > 0, x, 0.0), mask], dim=-1)


def _pick_bucket(buckets, n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _to_host(tree):
    """``tree``'s tensors as numpy arrays, in ONE device-to-host copy: the
    leaves' bytes are concatenated on the device first."""
    leaves = [t for _, t in flatten(tree)]
    if all(t.device.type == "cpu" for t in leaves):
        return map_leaves(lambda t: t.numpy(), tree)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in leaves:
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[at:at + nbytes].view(dtype).reshape(tuple(t.shape)))
        at += nbytes
    return unflatten(tree, out)


def _graphed(graphs, name: str, fn):
    """``fn`` through the one-call graphs ``graphs`` (None: ``fn`` itself),
    keyed by the endpoint ``name``; its arguments' shapes and its constant
    arguments (impute's rounds and mode) key the capture too."""
    if graphs is None:
        return fn
    return lambda *args: graphs.run(args, lambda a: fn(*a), key=(name,))


# ``train.graph``'s texts for the eager routes, kept here so that serving
# from artifacts on the CPU imports nothing of ``train``.
_ASKED_EAGER = "eager (asked for: graph=False, an entry's --no-graph)"
_CPU_EAGER = "eager (CPU tensors: a CUDA graph needs the card)"


def _graph_engine(device: torch.device, graph) -> tuple:
    """(route, the owner's ``train.graph.CallGraph`` or None for the eager
    route) for ``graph`` on ``device``, as ``train.graph.engines`` gives
    them."""
    if graph is False:
        return _ASKED_EAGER, None
    if graph is None and device.type != "cuda":
        return _CPU_EAGER, None
    from svax_torch.train import graph as cuda_graph

    return (cuda_graph.route(device, graph=graph),
            cuda_graph.engines(graph, kind=cuda_graph.CallGraph)(device))


def _bucketed_dispatch(buckets, fn, x, *args, device):
    """Pad to the bucket ladder; cut requests above the top bucket.

    Shared by the live ``SvaeServer`` and the exported ``ExportedServer``:
    the request moves to ``device`` once, each piece is padded with zero
    rows to its bucket, ``fn(piece, *args)`` runs, the padding rows are
    dropped on the device, and the answer comes back in one copy."""
    x = _rows(x).to(device)
    n, top = x.shape[0], buckets[-1]
    outs = []
    for start in range(0, n, top):
        piece = x[start:start + top]
        m = piece.shape[0]
        b = _pick_bucket(buckets, m)
        if m < b:
            piece = torch.cat([piece, piece.new_zeros((b - m,) + tuple(piece.shape[1:]))])
        out = fn(piece, *args)
        outs.append(map_leaves(lambda t, m=m: t[:m], out))
    if len(outs) > 1:
        parts = [[t for _, t in flatten(o)] for o in outs]
        outs = [unflatten(outs[0], [torch.cat(ts) for ts in zip(*parts)])]
    return _to_host(outs[0])


def _score_draws(gen: torch.Generator, num_samples: int, n: int, k: int, d: int):
    """The IW bound's Gumbel (S, n, K) and ε (S, n, K, d) draws from
    ``gen``, in the order ``evaluation.svae_iw_loglik`` draws them."""
    kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
    u = torch.rand((num_samples, n, k), **kw)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return gumbel, torch.randn((num_samples, n, k, d), **kw)


def _seeded_score(fn, num_samples: int, k: int, d: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return lambda piece: fn(piece, *_score_draws(gen, num_samples, piece.shape[0], k, d))


def _sin_posterior(pot_h: torch.Tensor, pot_p: torch.Tensor, exp):
    """The SIN combine's posterior (``models.svae.sin_combine``'s μ̃, chol J̃,
    log r̃ and log|J̃|; no Σ̃) from ``torch.linalg``'s batched Cholesky and
    two triangular solves — a few operations, where the training path's
    entry-unrolled forms trace to thousands of graph nodes at d = 8, which
    an exported program carries in its size and its trace and load times.
    ``cholesky_ex`` leaves the factorisation's status on the device (no
    host sync a call); ``torch.cholesky_solve`` is not used because on
    CUDA its batched solve (MAGMA's) allocates device memory itself, which
    a CUDA graph's capture cannot hold. ``pot_p`` is the diagonal (N, d)
    or the full (N, d, d) precision."""
    from svax_torch.models.svae import SinPosterior

    pot_prec = pot_p if pot_p.ndim == pot_h.ndim + 1 else torch.diag_embed(pot_p)
    prec = pot_prec[:, None] + exp.prec[None]  # (N, K, d, d)
    h = pot_h[:, None, :] + exp.prec_mean[None]  # (N, K, d)
    chol = torch.linalg.cholesky_ex(prec).L
    mean = torch.linalg.solve_triangular(
        chol.mT, torch.linalg.solve_triangular(chol, h[..., None], upper=False),
        upper=True)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
    log_rho = (exp.log_pi[None] + 0.5 * exp.logdet[None] - 0.5 * exp.quad[None]
               + 0.5 * (mean * h).sum(dim=-1) - 0.5 * logdet)
    return SinPosterior(mean=mean, prec_chol=chol, cov=None,
                        log_resp=torch.log_softmax(log_rho, dim=-1), logdet_prec=logdet)


def _model_fns(nn_params: dict, pgm_nat, spec: ModelSpec) -> dict:
    """The endpoints' bodies as functions of tensors (no padding, no
    host copies): encode(x), reconstruct(x), score(x, gumbel, eps),
    impute(xm, num_iters, hard). The GMM prior's posterior is
    ``_sin_posterior``; the SMM prior's is ``svae_smm.smm_combine``, and its
    score ``evaluation.svae_smm_iw_loglik``."""
    from svax_torch.models import evaluation, svae_smm
    from svax_torch.nets import mlp as nets
    from svax_torch.pgm import gmm

    exp = gmm.expected_params(pgm_nat)
    dec = nn_params["decoder"]

    act = spec.activation

    def posterior(x):
        pot_h, pot_p = nets.encoder_apply(nn_params["encoder"], x, act,
                                          head=spec.encoder_head)
        if spec.dof > 0.0:
            return svae_smm.smm_combine(pot_h, pot_p, exp, spec.dof, spec.smm_iters)[0]
        return _sin_posterior(pot_h, pot_p, exp)

    def z_mean(post):
        return torch.einsum("nk,nkd->nd", torch.exp(post.log_resp), post.mean)

    def decode(z):
        out = nets.decoder_apply(dec, z, spec.likelihood, act)
        return out[0] if spec.likelihood == "gaussian" else torch.sigmoid(out)

    def encode(x):
        post = posterior(x)
        return {"z_mean": z_mean(post), "responsibilities": torch.exp(post.log_resp),
                "component": torch.argmax(post.log_resp, dim=-1)}

    def reconstruct(x):
        return decode(z_mean(posterior(x)))

    def score(x, gumbel, eps):
        """``evaluation.svae_iw_loglik`` on injected draws: per (s, n) the
        Gumbel-max component, z = μ̃ + L̃⁻ᵀε for it alone, then
        lse_s[log p(x|z) + log p̄(z) − log q(z|x)] − log S, a chunk of
        samples at a time."""
        num_samples = eps.shape[0]
        if spec.dof > 0.0:
            return evaluation.svae_smm_iw_loglik(
                nn_params, pgm_nat, x, num_samples, dof=spec.dof, smm_iters=spec.smm_iters,
                gumbel=gumbel, eps=eps, likelihood=spec.likelihood,
                encoder_head=spec.encoder_head, activation=act)
        post = posterior(x)
        choice = torch.argmax(post.log_resp[None] + gumbel, dim=-1)  # (S, N)
        rows = torch.arange(x.shape[0], device=x.device)
        log_w = []
        for lo in range(0, num_samples, evaluation._IW_CHUNK):
            c = choice[lo:lo + evaluation._IW_CHUNK]
            e = torch.gather(eps[lo:lo + evaluation._IW_CHUNK], 2, c[:, :, None, None].expand(
                -1, -1, 1, eps.shape[-1]))[:, :, 0]  # (chunk, N, d)
            chol = post.prec_chol[rows[None, :], c]  # (chunk, N, d, d)
            z = post.mean[rows[None, :], c] + torch.linalg.solve_triangular(
                chol.mT, e[..., None], upper=True)[..., 0]
            loglik = nets.log_likelihood(dec, z, x[None], spec.likelihood, act)
            log_w.append(loglik + evaluation._expected_gmm_log_prob(z, exp)
                         - evaluation._mixture_log_q(z, post))
        return torch.logsumexp(torch.cat(log_w), dim=0) - math.log(float(num_samples))

    def impute(xm, num_iters: int, hard: bool = False):
        # xm packs [x | mask] (mask 1 = observed); padded rows arrive
        # all-missing and are dropped. Each round encodes, combines and
        # decodes — the responsibility-weighted posterior mean, or with
        # ``hard`` the MAP component's mean (the rule for multimodal
        # conditionals) — and writes the decoding into the missing
        # coordinates only, so observed ones pass through bit for bit.
        x, mask = torch.chunk(xm, 2, dim=-1)
        cur = mask * x
        rows = torch.arange(xm.shape[0], device=xm.device)
        for _ in range(num_iters):
            post = posterior(cur)
            if hard:
                z = post.mean[rows, torch.argmax(post.log_resp, dim=-1)]
            else:
                z = z_mean(post)
            cur = mask * x + (1.0 - mask) * decode(z)
        return cur

    return {"encode": encode, "reconstruct": reconstruct, "score": score,
            "impute": impute}


class SvaeServer:
    """Batched inference over a trained (GMM|SMM)-SVAE on one device.

    Every endpoint takes numpy or tensor input of shape (n, input_dim) for
    any n ≥ 1 and returns numpy arrays of the same leading length, computed
    on padded buckets (``_bucketed_dispatch``). On CUDA every endpoint but
    ``generate`` replays one CUDA graph per (endpoint, bucket, static
    arguments), captured at its first request; ``graph`` False keeps the
    eager route, ``"body"`` runs the captured bodies without a graph (the
    CPU tests' check), and ``route`` says which serves."""

    def __init__(self, nn_params: dict, pgm_nat, spec: ModelSpec,
                 buckets=_DEFAULT_BUCKETS, device=None, graph: bool | str | None = None):
        spec.check_supported()
        self.device = _device(device if device is not None else pgm_nat.dir_nat.device)
        move = lambda t: t.detach().to(device=self.device, dtype=torch.float32)  # noqa: E731
        self._nn = map_leaves(move, nn_params)
        self._nat = map_leaves(move, pgm_nat)
        self.spec = spec
        self.config = spec.to_config()
        self._buckets = tuple(sorted(buckets))
        self._fns = _model_fns(self._nn, self._nat, spec)
        self.route, self.graphs = _graph_engine(self.device, graph)
        self._served = {name: _graphed(self.graphs, name, fn) for name, fn in self._fns.items()}

    def _batched(self, fn, x, *args):
        with torch.inference_mode():
            return _bucketed_dispatch(self._buckets, fn, x, *args, device=self.device)

    def encode(self, x) -> dict:
        """Structured posterior: z_mean (n, d), responsibilities (n, K),
        hard component (n,)."""
        return self._batched(self._served["encode"], x)

    def reconstruct(self, x) -> np.ndarray:
        """The decoder at the posterior-mean latent: Gaussian mean or
        Bernoulli pixel probabilities, (n, input_dim)."""
        return self._batched(self._served["reconstruct"], x)

    def score(self, x, seed: int = 0, num_samples: int = 100) -> np.ndarray:
        """Per-point importance-weighted log-likelihood bound, (n,); the
        draws come from ``torch.Generator(device).manual_seed(seed)``."""
        return self._batched(_seeded_score(self._served["score"], num_samples,
                                           self.spec.num_components, self.spec.latent_dim,
                                           seed, self.device), x)

    def cluster(self, x) -> np.ndarray:
        """Hard cluster assignment, (n,) int."""
        return self.encode(x)["component"]

    def impute(self, x, mask, num_iters: int = 10, mode: str = "mean") -> np.ndarray:
        """Fill the missing coordinates by iterated structured decoding.

        ``mask`` is truthy where ``x`` is observed (broadcastable to x's
        shape; binarised); missing entries of ``x`` may hold anything, and
        observed ones come back untouched. ``mode="mean"`` decodes the
        responsibility-weighted posterior mean, ``mode="map"`` the MAP
        component's mean. Returns (n, input_dim): decoder means for a
        Gaussian likelihood, pixel probabilities for a Bernoulli one."""
        if mode not in ("mean", "map"):
            raise ValueError(f"mode must be 'mean' or 'map', got {mode!r}")
        return self._batched(self._served["impute"], _pack_masked(x, mask), num_iters,
                             mode == "map")

    def generate(self, num: int, seed: int = 0, sample_params: bool = False):
        """Sample the generative model: (x, z, component labels) as numpy."""
        from svax_torch.models import svae

        with torch.inference_mode():
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            out = svae.generate(self._nn, self._nat, gen, num, self.config,
                                sample_params=sample_params)
            return tuple(_to_host(list(out)))


# ---------------------------------------------------------------- exported tier


class _Endpoint(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serving(server: SvaeServer, directory: str | Path, buckets=None,
                   score_samples: int = 100, impute_iters: int = 10,
                   impute_mode: str = "mean", platforms=("cpu", "cuda"),
                   endpoints=_ENDPOINTS) -> dict:
    """Trace every endpoint × bucket with ``torch.export`` on the server's
    device and save ``<endpoint>_<bucket>.pt2`` plus ``exports.json``;
    ``endpoints`` names a subset of them to trace (the others are then not
    served from the artifacts).

    The weights become each program's constants. ``score`` is traced at a
    fixed ``score_samples`` with its Gumbel and ε draws as inputs;
    ``impute`` at a fixed ``impute_iters`` and ``impute_mode`` over the
    packed ``[x | mask]`` input. ``generate`` is not exported (its output
    shape is the request's); use a bundle. ``platforms`` lists the devices
    ``load_exported`` may move the programs to. Returns the manifest."""
    if impute_mode not in ("mean", "map"):
        raise ValueError(f"impute_mode must be 'mean' or 'map', got {impute_mode!r}")
    unknown = set(endpoints) - set(_ENDPOINTS)
    if unknown:
        raise ValueError(f"endpoints {sorted(unknown)}: the exported ones are {_ENDPOINTS}")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    buckets = tuple(sorted(buckets or server._buckets))
    spec, dev, fns = server.spec, server.device, server._fns
    d_in, k, d = spec.input_dim, spec.num_components, spec.latent_dim

    def impute_fixed(xm):
        return fns["impute"](xm, impute_iters, impute_mode == "map")

    def examples(name, b):
        zeros = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
        if name == "score":
            return zeros(b, d_in), zeros(score_samples, b, k), zeros(score_samples, b, k, d)
        return (zeros(b, 2 * d_in if name == "impute" else d_in),)

    bodies = {"encode": fns["encode"], "reconstruct": fns["reconstruct"],
              "score": fns["score"], "impute": impute_fixed}
    manifest = {
        "input_dim": d_in,
        "buckets": list(buckets),
        "score_samples": score_samples,
        "impute_iters": impute_iters,
        "impute_mode": impute_mode,
        "platforms": list(platforms),
        "artifacts": {},
        "device": str(dev),
        "num_components": k,
        "latent_dim": d,
    }
    with torch.no_grad():
        for name in (e for e in _ENDPOINTS if e in endpoints):
            files = {}
            for b in buckets:
                program = torch.export.export(_Endpoint(bodies[name]), examples(name, b))
                fname = f"{name}_{b}.pt2"
                torch.export.save(program, directory / fname)
                files[str(b)] = fname
            manifest["artifacts"][name] = files
    (directory / _EXPORT_MANIFEST).write_text(json.dumps(manifest, indent=2))
    return manifest


def load_exported(directory: str | Path, device=None,
                  graph: bool | str | None = None) -> "ExportedServer":
    """Serve from ``export_serving``'s artifacts alone (no model code), on
    ``device`` (default: the device they were traced on); ``graph`` as
    ``SvaeServer``'s."""
    return ExportedServer(Path(directory), device, graph)


class ExportedServer:
    """Batched inference over ``torch.export`` endpoint artifacts.

    The request contract of ``SvaeServer`` (any n ≥ 1, numpy out, the
    bucket ladder through ``_bucketed_dispatch``); each call runs a saved
    program. A program traced on one device is moved to another only on
    request, and only to one of the manifest's platforms; ``cuda`` without
    a card raises. On CUDA each program's ``module()`` is captured as a CUDA
    graph at its first call and replayed (``graph`` and ``route`` as
    ``SvaeServer``'s): the counterpart of the reference's compiled
    artifacts."""

    def __init__(self, directory: str | Path, device=None, graph: bool | str | None = None):
        directory = Path(directory)
        manifest = json.loads((directory / _EXPORT_MANIFEST).read_text())
        traced_on = torch.device(manifest["device"])
        self.device = _device(device if device is not None else traced_on)
        if self.device.type not in manifest["platforms"]:
            raise ValueError(f"device {self.device}: these artifacts list the platforms "
                             f"{manifest['platforms']}")
        self.input_dim = int(manifest["input_dim"])
        self.score_samples = int(manifest["score_samples"])
        self.impute_iters = int(manifest["impute_iters"])
        self.impute_mode = manifest["impute_mode"]
        self._k, self._d = int(manifest["num_components"]), int(manifest["latent_dim"])
        self._buckets = tuple(sorted(int(b) for b in manifest["buckets"]))
        self._arts = {}
        for name, files in manifest["artifacts"].items():
            self._arts[name] = {}
            for b, fname in files.items():
                program = torch.export.load(directory / fname)
                if self.device != traced_on:
                    from torch.export.passes import move_to_device_pass

                    program = move_to_device_pass(program, self.device)
                self._arts[name][int(b)] = program.module()
        self.route, self.graphs = _graph_engine(self.device, graph)

    def _call(self, name, x, *args):
        return _graphed(self.graphs, name, self._arts[name][x.shape[0]])(x, *args)

    def _dispatch(self, fn, x):
        with torch.inference_mode():
            return _bucketed_dispatch(self._buckets, fn, x, device=self.device)

    def encode(self, x) -> dict:
        return self._dispatch(lambda p: self._call("encode", p), x)

    def reconstruct(self, x) -> np.ndarray:
        return self._dispatch(lambda p: self._call("reconstruct", p), x)

    def score(self, x, seed: int = 0) -> np.ndarray:
        """The IW bound at the manifest's ``score_samples``, with the live
        server's draws for ``seed``."""
        return self._dispatch(_seeded_score(lambda p, g, e: self._call("score", p, g, e),
                                            self.score_samples, self._k, self._d, seed,
                                            self.device), x)

    def cluster(self, x) -> np.ndarray:
        return self.encode(x)["component"]

    def impute(self, x, mask) -> np.ndarray:
        """Missing-data fill-in at the manifest's ``impute_iters`` and
        ``impute_mode``; the mask contract of ``SvaeServer.impute``."""
        return self._dispatch(lambda p: self._call("impute", p), _pack_masked(x, mask))
