"""k-means++ initialisation of the mixture globals (``svax/pgm/init.py``).

``kmeanspp_centers`` is a numpy copy of the original (which imports JAX
through ``svax/__init__.py``); tests/test_torch_mixture.py pins it
bit-equal. Component locations follow the D² sampling rule.
"""

from __future__ import annotations

import numpy as np
import torch

from svax_torch.expfam.niw import NiwNat
from svax_torch.pgm.gmm import GmmNat


def kmeanspp_centers(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """k-means++ (D² weighting) center selection; x (N, d) → (k, d)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x)
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    d2 = np.sum((x - centers[0]) ** 2, axis=-1)
    for _ in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(n, 1.0 / n)
        centers.append(x[rng.choice(n, p=probs)])
        d2 = np.minimum(d2, np.sum((x - centers[-1]) ** 2, axis=-1))
    return np.stack(centers)


def init_variational_kmeanspp(prior: GmmNat, data: np.ndarray, seed: int = 0,
                              pseudo_counts: float = 2.0,
                              cov_scale: float = 1.0) -> GmmNat:
    """Prior + ``pseudo_counts`` pseudo-observations centred at k-means++
    seeds. The increment is a valid sufficient-statistic bundle, so the
    result is a valid NIW natural. The locations are cast to the prior's
    dtype in numpy, as the original does, before they reach torch."""
    ref = prior.niw_nat.eta1
    k, d = ref.shape
    np_dtype = torch.empty((), dtype=ref.dtype).numpy().dtype
    locs = kmeanspp_centers(np.asarray(data), k, seed=seed).astype(np_dtype)
    c = pseudo_counts
    outer = locs[:, :, None] * locs[:, None, :]
    eye = cov_scale * np.eye(d, dtype=np_dtype)
    kw = dict(device=ref.device, dtype=ref.dtype)
    inc = NiwNat(
        eta1=torch.tensor(c * locs, **kw),
        eta2=torch.full((k,), c, **kw),
        eta3=torch.tensor(c * (outer + eye), **kw),
        eta4=torch.full((k,), c, **kw),
    )
    return GmmNat(
        dir_nat=prior.dir_nat + c,
        niw_nat=NiwNat(*(a + b for a, b in zip(prior.niw_nat, inc))),
    )
