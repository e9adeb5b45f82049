#!/usr/bin/env python3
"""Smoke test of the svax_torch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
else. Phases (any failure raises and the exit code is non-zero):

1. the card: CUDA available; prints nvidia-smi's name/power limit and the
   torch version;
2. builds the CUDA kernels from svax_torch/ops/csrc (prints the time and
   nvcc's register/spill report);
3. the in-kernel Philox normals: 2^20 draws, |mean| < 0.005,
   |var − 1| < 0.01, same seed bit-equal, seed + 1 different;
4. the tinystep kernel against its plain PyTorch version at full pinwheel
   width (N=400, K=10, S=4, 50-50, σ=0.4), T=3 steps from one seeded state
   with injected numpy noise, at tests/test_tinystep_kernel.py's
   tolerances; then both timed per step;
5. the main path: ``svax_torch.train_svae --config pinwheel-svae`` for
   2 chunks of 1000 steps on the kernel with in-kernel noise, at the
   config's nn_precision "default" (tinystep's bf16-product mode), twice:
   every value finite, the kernel launched in that mode, the training ELBO
   improved, the two runs bit-equal; then once at ``--nn-precision
   highest`` (the f32 mode, this phase's kernel row's launches), and 50
   steps on the plain engine for its rate;
6. ptxas's line for every mixstep_kernel instantiation (both priors, each
   unroll; the phase fails on a missing line or a spill); the mixstep
   kernel against its plain version at full pinwheel-gmm
   width (N=400, K=10, d=2), GMM and SMM (dof 4), T=20, ρ=0.3 from a
   k-means++ state, at tests/test_mixstep_kernel.py's tolerances; then
   both timed per step (the kernel in chunks of 10,000 steps, the plain
   version in chunks of 100);
7. ptxas's line for every estep_tiles instantiation (the phase fails on
   a missing line or a spill); the estep kernel against its plain version
   at N=400, K=10, d=2 and at N=65,536, K=128, d=10 (seeded numpy data as
   in benchmarks/bench_estep.py), at bench_estep.py's bars, reruns
   bit-equal; then, in a fresh process (``measure_mixture.estep_times``),
   the kernel alone (profiler device time of every launch of a call), the
   kernels a call launches (one at N=400, or the phase fails), the wrapper
   and the plain version, beside the bound at both shapes;
8. the mixture main paths: ``svax_torch.train_gmm --config pinwheel-gmm
   --init kmeanspp`` on the kernel engine twice (mixstep launched, every
   value finite, the elbo not falling across the rows, the runs
   bit-equal); on the plain engine with ``--fused-kernel`` (estep launched
   once per step, final naturals within 1e-4 of the kernel run's); and
   ``svax_torch.train_smm --engine kernel``;
A. the flexstep kernel against its plain version at full auto-svae width
   (M=64, d_in=8, d=4, K=10, S=4, 100-100, ρ decay 1e-3), T=3 from one
   seeded state with an injected numpy batch stack and noise, at
   tests/test_flexstep_kernel.py's tolerances, and at d=2 and d=6 with
   small widths; then both timed per step (the kernel in chunks of 500,
   the plain version in chunks of 20);
B. the auto-svae main path: ``svax_torch.train_svae --config auto-svae
   --steps 1000`` (2 chunks of 500) on the kernel at the config's
   nn_precision "default" (flexstep's bf16-product mode), twice: flexstep
   launched in that mode, every value finite, the runs bit-equal, the
   final IW line printed; then seeds 1–3 once each: every seed's test
   ELBO/pt up by more than 4 nats, the best of seeds 0–3 above −12.3
   (tests/test_auto_quality_pin.py's bar); then once at ``--nn-precision
   highest`` (the f32 mode's launches), and 50 steps on the plain engine
   for its rate;
C. ptxas's line for every combine_fwd and combine_bwd_* instantiation
   (each d, both modes; the phase fails on a missing line or a spill);
   the combine kernels against their plain version at the mnist shape
   (N=256, K=10, d=8, S=1), the bigk shape (N=1024, K=100, d=10, S=1) and
   one rank's shape on phase I's 2x1 data mesh (N=512, K=100, d=10, S=1):
   values at tests/test_combine_kernel.py's bars (2e-5 for z, log r̃, μ̃;
   2e-4 for the local row and the statistics), the gradients to the
   potentials and every expected-parameter field through each of the five
   cotangent paths alone and all together (configuration (b): the
   backward with dw), and the potentials' gradients from the train step's
   cotangents (z, log r̃, the local row; configuration (a):
   combine_bwd_lean), 5e-4 of each gradient's largest entry, bit-equal
   reruns of forward and backward; the in-kernel ε
   recovered as L̃ᵀ(z − μ̃): |mean| < 0.005 and |var − 1| < 0.01 at bigk,
   the same seed and step bit-equal, another step or seed different, and
   the seeded gradients equal to those with the recovered ε injected; then,
   at mnist and bigk, the forward and the backward in both configurations
   timed (kernel and cross-block sum apart) against the plain version;
D. the mnist-svae main path: ``svax_torch.train_svae --config mnist-svae
   --steps 2000`` (the config's 1000 warmup steps, then chunks of 200 on
   the per-step engine with the combine kernels) for seeds 0 and 1: the
   combine kernels launched (every backward the train step's call, on
   combine_bwd_lean), two seed-0 runs cut to 200 warmup + 400 steps
   bit-equal (the full-length rerun went to pay for phase N), and each seed
   held to tests/test_mnist_quality_pin.py's floors — test ELBO/pt up by
   more than 100 nats, cluster purity of the test set above 0.7, at least
   6 of 10 components in use (computed here from the returned state; the
   entry prints none); then 40 steps on the plain engine for its rate, and
   50 steps of the kernel engine and 3 of the plain one, without the
   warmup, under ``torch.profiler`` for the device's idle share and the
   combine's share of device time; seed 0's first run writes its final
   state as a serving bundle (``--bundle-dir``) for phase L;
L. the training harness and the serving layer (``train.trainer``,
   ``train.checkpoint``, ``serve``): (1) ``train_svae --config
   pinwheel-svae`` 2000 steps against 1000 and ``--resume`` to 2000
   (tinystep), final checkpoints bit-equal; (2) ``SvaeTrainer`` on
   auto-svae, 1000 steps against 500 and a fresh trainer resuming
   (flexstep), bit-equal, the ``best`` summary's keys, one step under
   ``best/``; (3) ``SvaeTrainer`` at mnist-svae's width on the per-step
   engine with the combine and MLP-decoder kernels, 100 warmup + 200
   steps against 100 + 100 and a resume that skips the warmup, bit-equal;
   (4) ``GmmTrainer`` from a k-means++ start, 300 steps against 200 and a
   resume (mixstep), bit-equal, then ``fused=True`` on the per-step engine
   (one estep launch a step); (5) phase D's bundle on ``cuda``: requests
   of 1, 33, 512 and 8193 rows (padding invisible), the ``cpu`` server's
   encode within tests/test_torch_serve.py's rtol/atol 1e-5 and its
   components equal but for near ties, the cluster purity phase D reports,
   the mean score at 100 samples within 3 standard errors of the entry's
   IW bound, impute in both modes keeping observed pixels bit for bit,
   finite ``generate(12)``; (6) ``export_serving`` at buckets (32, 512) on
   ``cuda``, served by a fresh process whose import of the model modules
   raises (the graph engine ``train.graph`` alone allowed): encode,
   reconstruct and impute within 1e-6 of the live server, score and
   components bit-equal; both tiers' endpoints replayed as CUDA graphs
   (the default on the card) bit-equal to ``graph=False`` at 32, 512 and
   1024 rows (two pieces at the top bucket); the ms a step of each resume
   leg and each endpoint's live and exported latency at each bucket,
   graphed and eager in turns, beside the card line;
E. the fused MLP-decoder kernels against their plain version at the bigk
   (S=1, N=1024, K=100, d=10, 200-200, D=784), mnist (N=256, K=10, d=8)
   and a ragged shape (N=37, K=7, d=3, 24-40, D=50), and at one rank's
   bigk shape on phase I's 1x2 comp mesh (N=1024, K=50) and 2x1 data mesh
   (N=512, K=100): ll and every gradient
   (dz, dW1..3, db1..3, dy, dc) at measure_mnist.DECODER_TOL, reruns of
   forward and backward bit-equal; then both timed by CUDA events at bigk
   and mnist against the plain version and the unfused bf16 decoder they
   replace (``nets.bernoulli_loglik_decomposed(compute_dtype=bfloat16)``),
   saying whether the backward, and forward + backward, are no slower than
   the unfused ones, with their bound (bf16 tensor-core products, special
   functions at the card's maximum SM clock, bytes: the largest of the
   three) and the forward's share of it; the forward's ptxas lines (every
   ``decoder_fwd`` instantiation, 0 spill bytes or the phase fails);
F. the bigk-dp main path: ``svax_torch.train_svae --config bigk-dp`` cut to
   300 warmup and 600 joint steps at seed 0, twice: the decoder and
   combine kernels launched, the runs bit-equal, test ELBO/pt up by more
   than 100 nats, purity above 0.7, at least 6 components in use; then 10
   steps on the plain engine for its rate, and 50 steps of the kernel
   engine under ``torch.profiler`` for the idle share and the decoder's
   and combine's shares of device time;
G. tinystep's SMM branch (dof > 0, the Student-t mixture prior) against
   its plain version (``train_chunk_plain``, whose step is ``svae_smm``'s)
   at full pinwheel width (N=400, K=10, S=4, 50-50, σ=0.4), T=3 from one seeded
   state with injected numpy noise, at phase 4's tolerances: dof 4 with 2
   u–z rounds and full-chain gradients, the same with envelope gradients,
   and dof 2.5 with 1 round at 16-16 widths; then per step (T=200) the
   full-chain and envelope kernels beside the GMM branch in the same call
   and the plain SMM step; then the SMM main path, ``svax_torch.train_svae
   --config pinwheel-svae --smm-dof 4 --nn-precision highest`` (the f32
   mode; phase M runs the config's) for 2 chunks of 1000 steps with
   in-kernel noise, twice (tinystep launched, every value finite, the runs
   bit-equal, training ELBO and test ELBO/pt rising, the SMM IW line
   printed), and ``--config auto-svae --smm-dof 4 --steps 50`` twice on
   the per-step engine (finite, bit-equal);
H. ptxas's line for every log_rho_fwd instantiation (each d) and every
   log_rho_bwd instantiation (each d, with and without dw; the phase fails
   on a missing line or a spill); the
   component-parallel kernels (``ops/combine.py: log_rho_fused`` and
   ``combine_fused(log_norm=)``, combine.cu's ρ-kernels and log_norm
   mode) against their plain versions at the bigk (N=1024, K=100 and its
   two 50-shards, d=10, S=1) and pinwheel (N=400, K=10 in shards of 5,
   d=2, S=4) shapes: log ρ at 2e-5 and its gradients at 5e-4 of each
   largest entry, the backward in both configurations — (a) the train
   step's call, the potentials' gradients only, and (b) with dw; one
   shard's log_norm combine against the plain version
   with the normaliser from both shards' ρ-kernels (values at phase C's
   bars, every cotangent path alone and together, dn among them, and the
   train step's configuration (a) on combine_bwd_lean); the
   identity log_norm = lse(log ρ) against the softmax combine, and two
   shards' ρ-kernels, cross-shard lse and log_norm combines put together
   against the unsharded combine, values and gradients
   (tests/test_combine_kernel.py:223-262); reruns bit-equal; then the four
   kernels timed at one bigk shard against their plain versions (the
   ρ-kernel's and the log_norm combine's backwards in both configurations;
   the phase fails unless the ρ-kernel's forward and its (a) are one
   kernel a call), with their bounds; log ρ equal bit for bit to the
   log_norm combine's log r̃ at a zero normaliser at both shapes, each
   shard and every d (N=1024, K=50);
I. the parallel paths on the card, every rank on cuda:0 over gloo (named
   explicitly: NCCL refuses two ranks on one card): (a)
   ``parallel.dryrun.dryrun_multichip(4)`` on a 2x2 data x comp mesh —
   three ok lines, finite ELBOs, the gathered K-shards of the naturals
   within 1e-5 of the single-process step; (b) bigk-dp at full width from
   a 300-step warmup, 100 steps on a 1x2 comp mesh, twice: one launch per
   rank and step of each of the ρ-kernels and the log_norm combines, the
   runs bit-equal, every ρ-kernel backward the train step's configuration
   (a) (``ops.combine.rho_backward_paths``), step 1's naturals within 1e-5
   of the single-process step's, the test ELBO/pt rising; (c) the same on
   a 2x1 data mesh
   (step 1 against the single-process step on the same global batch);
   (d) ``svax_torch.train_gmm --dp --engine plain --fused-kernel`` on two
   ranks against the one-process run (300 estep launches per rank, rows
   from rank 0 only, final naturals, ELBO rows and predictive within
   1e-4); each rate beside phase F's, and 10 more steps of (b) and (c)
   under ``torch.profiler`` for each rank's kernel time and collectives;
J. the row-sum kernels (``ops/decoder.py: rowsum_logsig_neg``,
   decoder.cu) against their plain version at the bigk (M = S·N·K =
   102,400) and mnist (M = 2,560) shapes, Dh = 200, D = 784, in the f32 and
   the bf16-operand modes: s at rtol = atol = 2e-5 and H̄, W̄, b̄ within 5e-5
   of each largest entry (tests/test_kernel_interpret.py:82, :101; in the
   bf16 mode H̄ within 5e-3 with under 20% of entries beyond 5e-5,
   ``measure_mnist.ROWSUM_TOL``), and in the f32 mode H̄, W̄ within 2e-6
   of the plain version in f64 (f32-accurate products,
   ``measure_mnist.ROWSUM_F64_TOL``) and s no further from f64 than twice
   the plain version's, reruns bit-equal; each timed by CUDA events beside
   its plain version and the unfused f32 row sum it replaces (saying
   whether each is no slower), its bound and the forward's share of it;
   the forward's ptxas lines (every ``rowsum_fwd`` instantiation, 0 spill
   bytes or the phase fails);
K. the big-K f32 ``fused_decoder`` path: (a) 3 steps of bigk-dp's step at
   full width with an f32 decoder (``make_step_runner``) from one seeded
   state with injected numpy ε, the row sum in the kernels against the
   unfused one (ELBO, parameters, Adam moments, naturals at the stated
   bars, ``ROWSUM_STEP_BARS``), at nn_precision "highest" (the f32 mode)
   and "high" (the bf16-operand mode); (b) ``svax_torch.train_svae
   --config bigk-dp --nn-compute-dtype float32 --no-fused-mlp-decoder
   --fused-decoder`` at the default nn_precision "high" (the row sum's
   bf16-operand mode, as the reference's ``_kernel_precision`` maps HIGH)
   cut to 300 warmup and 600 joint steps: one row-sum forward and backward
   a step (plus a forward per test ELBO), every one in the bf16-operand
   mode, the MLP-decoder kernels not launched, phase F's floors (rise > 100
   nats, purity > 0.7, ≥ 6 components); (b') the same at ``--nn-precision
   highest`` cut to 100 + 100 steps (the f32 mode's launches); (c) the
   step's rate with the row sum fused and unfused, in turns, and 20
   profiled steps of each;
M. slice J: (1) ptxas's line for every bf16-product instantiation of
   tinystep and flexstep (a missing line fails the phase, and so does a
   spill where the f32 mode has none: tinystep's both widths, flexstep's
   d ≤ 4); tinystep's bf16-product mode against its plain version (the
   plain step at nn_precision "default") at full pinwheel width, GMM and
   SMM (dof 4), and at 16-16, T=3 with injected numpy noise, and
   flexstep's at full auto width and at d=2 and d=6, each at the bars
   ``BF16_TINY_TOL`` / ``BF16_FLEX_TOL`` with bit-equal reruns; both
   modes' per-step times in turns beside the bound; (2) the flagship at
   its config runs the bf16-product mode in phases 5 and B, held to their
   floors there, and ``--smm-dof 4`` at the config here (2000 steps,
   rising); (3) ``train_svae --config mnist-svae --encoder-head full
   --fused-mlp-decoder`` cut to 60 warmup + 60 steps: the per-step
   engine, no combine launch (the fused combine takes the diagonal head
   only), MLP-decoder launches, test ELBO/pt up by more than 100 nats,
   purity and components printed; (4) ``train_svae --config bigk-dp
   --recon-mode sampled`` cut to 20 warmup + 20 steps: finite, rising,
   its ms a step beside phase F's weighted step; (5) is phase K at the new
   default; (6) a full-head ReLU bundle at mnist width (20 steps on from
   (3)'s state), served on ``cuda``: its exported tier at bucket 32
   against the live one (encode, reconstruct, impute within 1e-6, score
   and components bit-equal);
N. slice H, the three-model comparison (``svax_torch.compare``) at the
   comparison's own SvaeConfig (nn_precision "high": the kernels' f32
   mode), each leg's wall seconds and engine printed, the rows written
   under ``build/chip_smoke_N/``, never ``runs/``: (1) ``compare --quick
   --engine kernel`` for pinwheel and auto: tinystep and flexstep launched
   in their f32 mode (``launches``, not ``launches_bf16``), the budget
   naming the kernel and the mode, every IW bound and predictive finite;
   (2) mnist at ``--quick`` with the SVAE leg cut to 20 warmup + 20 steps
   (the per-step engine, its reason recorded) and the Bernoulli mixture at
   its full 300 steps, held to ``BMM_FLOOR``, and the same leg from the
   reference's initial rows (``compare.REFERENCE_INIT_ROWS``) within 0.1
   nat/point of the reference's −227.946; (3) auto at its full budget,
   seed 0 (3000 steps a leg, IW 1000): the SVAE on flexstep, ``svae_beats_vae``,
   each leg within 4 sd of the reference's 8-seed mean (−8.945 ± 0.046,
   −9.118 ± 0.044), the GMM leg above ``GMM_AUTO_FLOOR`` and, from the
   reference's rows, within 0.05 of −8.969;
O. slice K, the seed studies and reproduce, on the card, writing under
   ``build/chip_smoke_O/``: (1) ``seed_sweep --engine kernel --variants
   aug0.4+rs2 --seed-list 0..5 --nn-precision default`` (15,000 steps,
   IW 1000; tinystep's bf16-product mode, at least 180 launches, every
   value finite), each seed's line printed, gated on the reference's
   32-seed statistics (runs/seed_sweep_r5_mega_default32.json: −5.569 ±
   0.346, 13/32 crossing): the 6 seeds' mean IW at least −5.569 −
   3·0.346/√6 and at least one above −5.41; (2) ``reproduce --quick
   --stages gmm svae auto-tt serve`` (mixstep, tinystep's f32 GMM and SMM
   branches, flexstep's f32 mode, the per-step engine, its mnist-svae and
   bigk-dp rows cut to 2 steps), each stage's
   seconds and rows printed: every row finite, the serve round-trip
   finite, the pure GMM using at least 6 components, tinystep's SMM
   branch launched (its own count, ``tinystep.launches_smm``); the
   launches join the kernels line's counts;
P. slice L, the demos, on the card (tinystep's f32 mode, GMM and SMM
   branches; matplotlib is not needed: no figure is drawn), writing under
   ``build/chip_smoke_P/``: (1) ``anomaly_demo --outlier-scale 30 --steps
   15000`` (the separated regime, GMM and ``--dof 4``): ROC-AUC at least
   the reference's 0.962 / 0.953 less 0.05; (2) ``robustness_demo --steps
   3000`` (tanh): each clean-test ELBO/pt within 1 nat of the reference's
   −7.05 / −7.36, the SMM model's E[u] finite; (3)
   ``latent_contamination_demo`` at its defaults (15,000 pretraining steps
   at σ = 0.4, 500 online steps, 25% at ±30, IW 1000): ``smm_win_nats`` >
   0 (reference +0.147) and the mean E[u] on the outlier rows below the
   clean rows' (reference 0.78 against 1.10); (4) ``impute_demo``'s
   pinwheel leg at ``--quick`` and its mnist leg at 20 warmup + 20 steps
   (the per-step engine), both at 3 impute rounds (the demo's 10 cut), every
   fill finite and the exported tier within phase L's 1e-6 of the live one,
   both decode rules; the latent demo's online rules run as a CUDA graph
   (its printed route), and both rules over 200 steps graphed against the
   eager loop (``measure_graphs.online_routes``): the naturals and E[u]
   bit-equal, ms a step; the launches, counted
   around the phase, join tinystep's f32 and SMM rows of the kernels line;
Q. the graphed runners (``train.graph``; phases D, F, K, L, N, O and P
   above already run them, the default on CUDA): mnist-svae and bigk-dp
   at their configs' full widths for 100 steps each, the full recognition
   head at mnist width (the plain combine) for 10 and the comparison's
   pinwheel VAE for 200, each in a chunk of 3/4 and a shorter one of the
   rest (one capture replayed), graphed against the eager loop
   (``graph=False``) in turns (``measure_graphs.equal_routes``): the final
   states and every metric bit-equal; each route's steps/s (the graph's
   over its second chunk, after the capture), the capture seconds and the
   device memory the capture reserved; then each route's wall, device time
   a step and idle share from one short profile of every path on each
   route in one fresh process (``timed_fresh``: ``measure_graphs.profile_smoke``);
   and the held-out evaluation (``svae_step.make_eval_fn``, one captured
   call, ``train.graph.CallGraph``) on the kernel engine at mnist-svae,
   bigk-dp and the big-K f32 config (``--fused-decoder``), 3 calls on the
   test set with the state 10 graphed steps on between calls
   (``measure_graphs.eval_routes``): the four terms bit-equal to the
   eager call, the combine forward, the decoder_mlp forward (bigk-dp) and
   the row-sum forward (big-K f32) launched inside the graph once a call,
   as many times as eagerly; those launches join the kernels line;
9. prints the kernels line — per kernel its launches on its main path, its
   error against the plain version, its time and the plain version's, and
   ``bound_ms``, the least time the card could take for the same work (the
   larger of its bytes over 3.35 TB/s and its operations over the 67
   TFLOP/s f32 peak — for the decoder kernels, the bf16 tensor-core peak
   and the special-function rate, and for the row-sum kernels' f32 mode,
   the fastest f32-accurate product on the tensor cores (three TF32
   passes) and the special-function rate — counted from this run's shapes;
   tinystep's and flexstep's bf16-product rows are phase M's (their
   launches phases 5's and B's main paths at the configs' "default"); the
   row sum's rows come in both modes (launches: phase K (b') and (b));
   the decoder and row-sum kernels' times are CUDA-event times, the other
   per-call kernels' profiler device times, each taken in a fresh process
   (``timed_fresh``; a profiled kernel that launched and reads no time
   fails its phase);
   the combine backwards' entries are the train step's call (combine_bwd_lean,
   configuration (a): its launches, time and bound), with the backward for
   every cotangent and dw beside them (``full_ms``, ``full_plain_ms``,
   ``full_bound_ms``), and so are the ρ-kernel backward's (configuration
   (a) without dw, (b) with it); the component-parallel kernels' launches are phase
   I (b)'s first run's, both ranks; the row-sum kernels' phase K (b)'s,
   with their times in the f32 mode at bigk beside the unfused f32 row
   sum's) — the card line, and
   last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_fresh(func: str, *args: int, module: str = "measure_mnist") -> dict:
    """``svax_torch.<module>.<func>(cuda:0, *args)`` in a fresh process from
    this checkout, which loads the kernel library phase 2 built (no
    arguments: ``<func>()``). torch.profiler has dropped all of a short
    profile's device events late in a long process, so the per-call
    profiles are taken in a process of their own. A child whose profile
    still read no device time for a kernel it launched is run once more;
    any other failure raises."""
    code = ("import json, sys, torch\n"
            f"from svax_torch import {module} as mod\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "a = [int(v) for v in sys.argv[2:]]\n"
            "t = getattr(mod, sys.argv[1])(*([torch.device('cuda', 0), *a] if a else []))\n"
            "print('RESULT ' + json.dumps(t))\n")
    what = f"{func}{tuple(args) if args else ''}"
    for attempt in range(2):
        out = subprocess.run([sys.executable, "-c", code, func, *map(str, args)],
                             cwd=Path(__file__).resolve().parent, capture_output=True,
                             text=True, timeout=600)
        if out.returncode == 0:
            return json.loads([ln for ln in out.stdout.splitlines()
                               if ln.startswith("RESULT ")][-1][len("RESULT "):])
        if attempt == 0 and "recorded no device time" in out.stderr:
            print(f"{what}: the profile read no device time; once more in another fresh "
                  "process", flush=True)
            continue
        raise RuntimeError(f"{what} in a fresh process exited {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    raise AssertionError("unreachable")


def flat(tree: dict) -> list:
    """The tensors of an nn_params-layout tree, in a fixed order."""
    return [t for side in tree.values() for ly in side for t in ly.values()]


def leaves(state) -> list:
    """Every tensor of a train state, in a fixed order."""
    return (flat(state.nn_params) + flat(state.opt_state.mu)
            + flat(state.opt_state.nu)
            + [state.pgm_nat.dir_nat, *state.pgm_nat.niw_nat])


def close(name, got, ref, rtol, atol) -> float:
    """Assert |got − ref| ≤ atol + rtol·|ref| elementwise; returns max |got − ref|."""
    import torch

    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def time_per_step(fn, steps: int, repeats: int = 3) -> float:
    """Median device milliseconds per train step of fn() (CUDA events)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return sorted(times)[len(times) // 2]


# One H100 SXM, peak rates from its data sheet: f32 outside the tensor
# cores, and device memory.
F32_FLOPS = 67e12
MEM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for work of ``flops``
    operations at ``peak`` (f32 unless given) that moves ``nbytes`` — the
    larger of the two times."""
    t_ops, t_bytes = flops / peak, nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def n_params(tree: dict) -> int:
    return sum(t.numel() for t in flat(tree))


def nat_leaves(nat) -> list:
    return [nat.dir_nat, *nat.niw_nat]


def to_device(nat, dev):
    return type(nat)(nat.dir_nat.to(dev), type(nat.niw_nat)(*(t.to(dev) for t in nat.niw_nat)))


def rel_err(got, ref) -> float:
    """max |got − ref| / max |ref| (benchmarks/bench_estep.py's measure)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def forward_ptxas(name: str, phase: str) -> None:
    """Print ptxas's line for each instantiation of the forward kernel
    ``name`` in the kernel library's build log; raise if there is none or
    one spills."""
    from svax_torch.measure_mnist import kernel_resources
    from svax_torch.ops import _build

    _build.build()  # the kernel library, built in phase 2: sets build_log to its log
    lines = kernel_resources(_build.build_log, name)
    if not lines:
        raise RuntimeError(f"phase {phase}: no ptxas line for {name} in the build log")
    for line in lines:
        print(f"phase {phase}: ptxas {line}", flush=True)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill is None or int(spill.group(1)) != 0:
            raise RuntimeError(f"phase {phase}: {line}: spills (or no spill count)")


def instances_ptxas(phase: str, name: str, want: set, spill_free: set | None = None) -> None:
    """Print ptxas's line for every instantiation of kernel ``name`` (its
    template arguments as a tuple of ints in ``want``) in the kernel
    library's build log; raise if one is missing or spills (with
    ``spill_free``, if one of those spills)."""
    from svax_torch.measure_mnist import kernel_resources
    from svax_torch.ops import _build

    _build.build()  # the kernel library, built in phase 2: sets build_log to its log
    seen = set()
    for line in kernel_resources(_build.build_log, name):
        print(f"phase {phase}: ptxas {line}", flush=True)
        spill = re.search(r"(\d+) bytes spill stores", line)
        m = re.match(rf"{name}<([\d, ]+)>", line)
        args = tuple(int(v) for v in m.group(1).split(", ")) if m else None
        if (spill_free is None or args in spill_free) and (
                spill is None or int(spill.group(1)) != 0):
            raise RuntimeError(f"phase {phase}: {line}: spills (or no spill count)")
        if args is not None:
            seen.add(args)
    missing = want - seen
    if missing:
        raise RuntimeError(f"phase {phase}: no ptxas line for {name}{sorted(missing)}")


def combine_ptxas(phase: str) -> None:
    """ptxas's line for every combine_fwd and combine_bwd_* instantiation
    (each d of the shape class, both modes)."""
    for name in ("combine_fwd", "combine_bwd_lean", "combine_bwd_sample", "combine_bwd_local"):
        instances_ptxas(phase, name, {(d, mode) for d in (2, 3, 4, 6, 8, 10) for mode in (0, 1)})


def estep_ptxas(phase: str) -> None:
    """ptxas's line for every estep_tiles instantiation (component pairs ×
    feature tiles) and for estep_reduce; raise if one is missing or
    spills."""
    from svax_torch.ops import _build

    instances_ptxas(phase, "estep_tiles", {(kq, fm) for kq in (1, 2, 4, 8) for fm in range(1, 6)})
    # estep_reduce is not a template: its entry, then its spill and register lines.
    m = re.search(r"Compiling entry function '\w*estep_reduce\w*'.*?(\d+) bytes spill stores"
                  r".*?Used (\d+) registers", _build.build_log, re.S)
    if m is None or int(m.group(1)) != 0:
        raise RuntimeError(f"phase {phase}: estep_reduce: no ptxas line, or it spills")
    print(f"phase {phase}: ptxas estep_reduce: {m.group(2)} registers, 0 bytes spill stores",
          flush=True)


def combine_times_line(t: dict, prefix: str, fb, ab, bb) -> str:
    """Phases C and H: the combine's per-call device times (``time_combine``'s
    keys after ``prefix``) in both configurations, kernel and cross-block
    sum apart, beside the plain version's and the bounds."""
    def part(key, bound):
        return (f"{t[f'kernel_{prefix}{key}_device']:.4f} (kernel "
                f"{t[f'kernel_{prefix}{key}_kernel']:.4f} + reduce "
                f"{t[f'kernel_{prefix}{key}_reduce']:.4f}; plain "
                f"{t[f'plain_{prefix}{key}_device']:.4f}; CUDA events "
                f"{t[f'kernel_{prefix}{key}_call']:.4f}; bound {bound[0] * 1e3:.3f} us, "
                f"{bound[1]})")
    return (f"device ms per call: forward {part('fwd', fb)}; backward (a), the train "
            f"step's {part('bwd_a', ab)}; backward (b), every cotangent and dw "
            f"{part('bwd_b', bb)}")


def mixture_phases(card: str) -> list:
    """Phases 6–8; returns the mixstep and estep entries of the kernels line."""
    import torch

    from svax_torch import train_gmm, train_smm
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.measure_mixture import ESTEP_SHAPES, estep_bound, estep_inputs
    from svax_torch.models.gmm_baseline import GmmTrainState
    from svax_torch.models.smm_baseline import SmmTrainState
    from svax_torch.ops import estep, mixstep
    from svax_torch.pgm import gmm
    from svax_torch.pgm.init import init_variational_kmeanspp

    dev = torch.device("cuda", 0)

    # 6. mixstep against plain at full pinwheel-gmm width
    instances_ptxas("6", "mixstep_kernel", {(smm, u) for smm in (0, 1) for u in (1, 2, 4, 8)})
    train, _ = load_pinwheel(seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    prior_cpu = gmm.make_prior(10, 2, alpha=1.0, kappa=0.05)
    nat0 = to_device(init_variational_kmeanspp(prior_cpu, train, seed=0), dev)
    prior = to_device(prior_cpu, dev)
    errs, times = {}, {}
    for name, dof, cls in (("gmm", 0.0, GmmTrainState), ("smm", 4.0, SmmTrainState)):
        state = cls(nat=nat0, step=0)
        kw = dict(rho=0.3, dof=dof)
        st_k, met_k = mixstep.train_chunk(state, prior, x, t_steps=20, **kw)
        torch.cuda.synchronize()
        st_p, met_p = mixstep.train_chunk_plain(state, prior, x, t_steps=20, **kw)
        nat_err = max(close(f"mixstep {name} naturals", a_, b_, 3e-4, 3e-4)
                      for a_, b_ in zip(nat_leaves(st_k.nat), nat_leaves(st_p.nat)))
        ev_err = close(f"mixstep {name} local evidence", met_k["local_evidence"],
                       met_p["local_evidence"], 2e-4, 2e-3)
        errs[name] = nat_err
        t_kernel, t_plain = 10_000, 100
        times[name] = (
            time_per_step(lambda: mixstep.train_chunk(state, prior, x, t_steps=t_kernel,
                                                      **kw), t_kernel),
            time_per_step(lambda: mixstep.train_chunk_plain(state, prior, x,
                                                            t_steps=t_plain, **kw),
                          t_plain))
        print(f"phase 6: mixstep {name} vs plain, T=20 rho=0.3 at N=400 K=10 d=2: "
              f"naturals max abs err {nat_err:.3e} (rtol 3e-4 atol 3e-4), local "
              f"evidence {ev_err:.3e} (rtol 2e-4 atol 2e-3); per step: kernel "
              f"{times[name][0] * 1e3:.3f} us (chunks of {t_kernel}), plain "
              f"{times[name][1]:.4f} ms (chunks of {t_plain}); {card}")

    # 7. estep against plain, pinwheel shape and the design shape
    estep_ptxas("7")
    est_err, est = {}, {}
    for n, k, d in ESTEP_SHAPES.values():
        xe, exp = estep_inputs(dev, n, k, d)
        stats, ev = estep.e_step_stats_fused(xe, exp)
        torch.cuda.synchronize()
        ref, ref_ev = estep.e_step_stats_reference(xe, exp)
        rel = max(rel_err(a_, b_) for a_, b_ in zip(stats, ref))
        ev_err = float((ev.double() - ref_ev.double()).abs().max())
        abs_err = max(float((a_.double() - b_.double()).abs().max())
                      for a_, b_ in zip(stats, ref))
        if not (rel < 5e-5 and ev_err < 1e-3):
            raise AssertionError(f"estep at N={n} K={k} d={d}: stats rel err {rel:.3e} "
                                 f"(bar 5e-5), evidence abs err {ev_err:.3e} (bar 1e-3)")
        again, ev2 = estep.e_step_stats_fused(xe, exp)
        assert all(torch.equal(a_, b_) for a_, b_ in zip(stats, again)) and \
            torch.equal(ev, ev2), "two estep calls differ"
        est_err[(n, k, d)] = (abs_err, rel, ev_err)
    # The times from a fresh process (the kernel alone under torch.profiler,
    # the wrapper and the plain version by CUDA events), as phases C and H.
    etimes = timed_fresh("estep_times", module="measure_mixture")
    for label, (n, k, d) in ESTEP_SHAPES.items():
        t, b = etimes[label], estep_bound(n, k, d)
        abs_err, rel, ev_err = est_err[(n, k, d)]
        if n == 400 and (t["kernels"] != 1 or t["estep_kernels"] != 1):
            raise AssertionError(f"estep at N=400: {t['kernels']} device kernels a call "
                                 f"({t['estep_kernels']} of estep), not one launch")
        est[label] = (t, b)
        print(f"phase 7: estep vs plain at N={n} K={k} d={d}: stats max err / max|ref| "
              f"{rel:.3e} (bar 5e-5), max abs err {abs_err:.3e}, evidence max abs err "
              f"{ev_err:.3e} (bar 1e-3), reruns bit-equal; per call: the kernel alone "
              f"{t['kernel_ms']:.4f} ms (profiler, {t['estep_kernels']:g} launches, "
              f"{t['kernels']:g} device kernels a call), the wrapper {t['wrapper_ms']:.4f} ms "
              f"(CUDA events, back to back), plain {t['plain_ms']:.4f} ms (events; its "
              f"kernels {t['plain_device_ms']:.4f} ms); bound {b['ms'] * 1e3:.4g} us, "
              f"{b['by']} (three TF32 passes over F' = {1 + d + d * (d + 1) // 2}; f32 FMAs "
              f"over F = {1 + d + d * d}: {b['f32_fma_ms'] * 1e3:.4g} us); {card}")

    # 8. the mixture main paths
    argv = ["--config", "pinwheel-gmm", "--init", "kmeanspp", "--device", "cuda"]
    mixstep.launches = 0
    run1 = train_gmm.main(argv)
    mix_launches = mixstep.launches
    assert mix_launches >= 1, f"mixstep launched {mix_launches} times on the main path"
    rows = run1["rows"]
    assert rows and all(math.isfinite(v) for r in rows for v in r.values()), rows
    assert all(bool(torch.isfinite(t).all()) for t in nat_leaves(run1["state"].nat))
    assert math.isfinite(run1["test_predictive_loglik_per_point"])
    elbos = [r["elbo"] for r in rows]
    # VBEM at rho = 1 raises the bound each step; at convergence float32
    # rounding moves it by ~1e-7 relative either way.
    assert all(b >= a - 1e-5 * abs(a) for a, b in zip(elbos, elbos[1:])), elbos
    run2 = train_gmm.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(nat_leaves(run1["state"].nat), nat_leaves(run2["state"].nat))), \
        "two train_gmm runs at one seed differ"
    estep.launches = 0
    fused = train_gmm.main([*argv, "--engine", "plain", "--fused-kernel"])
    est_launches = estep.launches
    assert est_launches == 300, f"estep launched {est_launches} times in 300 steps"
    for p, q in zip(nat_leaves(fused["state"].nat), nat_leaves(run1["state"].nat)):
        err = rel_err(p, q)
        assert err < 1e-4, f"plain+fused vs kernel final naturals: rel err {err:.3e}"
    mixstep.launches = 0
    smm_run = train_smm.main(["--init", "kmeanspp", "--device", "cuda",
                              "--engine", "kernel"])
    smm_launches = mixstep.launches
    assert smm_launches >= 1 and all(math.isfinite(r["elbo"]) for r in smm_run["rows"])
    print(f"phase 8: train_gmm (kernel): {mix_launches} mixstep launches, "
          f"{run1['steps_per_s']:.1f} steps/s, predictive "
          f"{run1['test_predictive_loglik_per_point']:.5f}, purity "
          f"{run1['train_cluster_purity']}, runs bit-equal; train_gmm (plain, "
          f"--fused-kernel): {est_launches} estep launches, "
          f"{fused['steps_per_s']:.1f} steps/s, predictive "
          f"{fused['test_predictive_loglik_per_point']:.5f}; train_smm (kernel): "
          f"{smm_launches} mixstep launches, {smm_run['steps_per_s']:.1f} steps/s, "
          f"final elbo {smm_run['rows'][-1]['elbo']:.4f}; {card}")

    abs_err = est_err[ESTEP_SHAPES["pinwheel"]][0]
    (t_e, b_e), (t_design, b_design) = est["pinwheel"], est["design"]
    # mixstep, per GMM step at N=400, K=10, d=2 (chunks of 10,000): per (n, k)
    # log ρ (2(d² + 2d) + 4), its exp and normalisation (3) and the weighted
    # statistics (2(1 + d + d(d+1)/2)); x, the naturals and the prior read and
    # the naturals written once per chunk, one metric per step.
    n_mix, k_mix, d_mix, t_mix = x.shape[0], 10, 2, 10_000
    mix_bound = bound(
        n_mix * k_mix * (2 * (d_mix ** 2 + 2 * d_mix) + 4 + 3
                         + 2 * (1 + d_mix + d_mix * (d_mix + 1) // 2)),
        4 * (n_mix * d_mix + 3 * k_mix * 9) / t_mix + 4)
    return [
        {"name": "mixstep", "route": "cuda", "source": "svax_torch/ops/csrc/mixstep.cu",
         "replaces": "svax/ops/mixstep_pallas.py:163", "launches": mix_launches,
         "max_abs_err": max(errs.values()), "ms": times["gmm"][0],
         "plain_ms": times["gmm"][1], "bound_ms": mix_bound[0], "bound_by": mix_bound[1],
         "library_ms": None},
        {"name": "estep", "route": "cuda", "source": "svax_torch/ops/csrc/estep.cu",
         "replaces": "svax/ops/estep_pallas.py:161", "launches": est_launches,
         "max_abs_err": abs_err, "ms": t_e["kernel_ms"], "plain_ms": t_e["plain_device_ms"],
         "bound_ms": b_e["ms"], "bound_by": b_e["by"], "library_ms": None,
         "wrapper_ms": t_e["wrapper_ms"], "plain_call_ms": t_e["plain_ms"],
         "design_ms": t_design["kernel_ms"], "design_bound_ms": b_design["ms"]},
    ]


def auto_phases(card: str) -> tuple[dict, int]:
    """Phases A and B; returns the flexstep entry of the kernels line and the
    main path's bf16-product-mode launches."""
    import numpy as np
    import torch

    from svax_torch import train_svae
    from svax_torch.data import load_dataset
    from svax_torch.measure_auto import step_fmas
    from svax_torch.measure_mnist import kernel_resources
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import flexstep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    dev = torch.device("cuda", 0)

    def setup(d, d_in, k, s, hidden, m, data=None, seed=0):
        gen = torch.Generator().manual_seed(seed)
        x = torch.tensor(data, dtype=torch.float32) if data is not None else (
            torch.randn(120, d_in, generator=gen))
        n = x.shape[0]
        config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s, num_total=n)
        prior = gmm.make_prior(k, d, kappa=0.05)
        state = svae_step.init_state(gen, d_in, config, prior, hidden, hidden)
        return svae_step.state_to(state, dev), svae_step.nat_to(prior, dev), x.to(dev)

    def stack(x, t, m, seed):
        rng = np.random.default_rng(seed)
        return x[torch.tensor(rng.integers(0, x.shape[0], (t, m)), device=dev)].contiguous()

    # A. kernel against plain: full auto width, then d = 2 and d = 6 small.
    train, _, _ = load_dataset("auto", seed=0)
    full = dict(d=4, d_in=8, k=10, s=4, hidden=(100, 100), m=64)
    cases = [("auto width", full, train),
             ("d=2", dict(d=2, d_in=3, k=5, s=2, hidden=(16, 16), m=32), None),
             ("d=6", dict(d=6, d_in=8, k=3, s=2, hidden=(24, 24), m=32), None)]
    from svax_torch.ops import _build

    _build.build()  # the kernel library, built in phase 2: sets build_log to its log
    lines = kernel_resources(_build.build_log, "flexstep_kernel")
    if not lines:
        raise RuntimeError("phase A: no ptxas line for flexstep_kernel in the build log")
    for line in lines:
        print(f"phase A: ptxas {line}")
    # The auto width at every cluster size, the small shapes at the default.
    cases = [(f"{name}, cluster {cluster}", c, data, cluster)
             for name, c, data in cases
             for cluster in (flexstep.CLUSTER_SIZES if name == "auto width"
                             else (flexstep.DEFAULT_CLUSTER,))]
    errs = {}
    for name, c, data, cluster in cases:
        state, prior, x = setup(**c, data=data)
        t = 3
        batches = stack(x, t, c["m"], 1)
        rng = np.random.default_rng(2)
        eps = torch.tensor(rng.standard_normal((t, c["s"], c["m"], c["k"], c["d"])),
                           dtype=torch.float32, device=dev)
        kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=x.shape[0], eps=eps)
        st_k, met_k = flexstep.train_chunk(state, prior, batches, cluster=cluster, **kw)
        torch.cuda.synchronize()
        st_p, met_p = flexstep.train_chunk_plain(state, prior, batches, **kw)
        e = {"params": max(close(f"flexstep {name} params", a_, b_, 5e-4, 5e-5)
                           for a_, b_ in zip(flat(st_k.nn_params), flat(st_p.nn_params))),
             "adam m": max(close(f"flexstep {name} adam m", a_, b_, 5e-4, 1e-5)
                           for a_, b_ in zip(flat(st_k.opt_state.mu),
                                             flat(st_p.opt_state.mu))),
             "naturals": max(close(f"flexstep {name} naturals", a_, b_, 5e-4, 5e-4)
                             for a_, b_ in zip(nat_leaves(st_k.pgm_nat),
                                               nat_leaves(st_p.pgm_nat)))}
        for key, tol in (("recon", 2e-3), ("local_kl", 2e-3), ("neg_loss", 1e-4),
                         ("rho", 1e-6)):
            e[key] = close(f"flexstep {name} {key}", met_k[key], met_p[key], tol, tol)
        assert st_k.step == st_p.step == t and st_k.opt_state.count == t
        errs[name] = e
        print(f"phase A: flexstep vs plain, T=3 at {name} {c}: "
              + ", ".join(f"{k_} max abs err {v:.3e}" for k_, v in e.items())
              + " (params rtol 5e-4 atol 5e-5; m 5e-4/1e-5; naturals 5e-4/5e-4; recon, "
              "local_kl 2e-3; neg_loss 1e-4; rho 1e-6)")
    max_abs_err = max(errs[f"auto width, cluster {flexstep.DEFAULT_CLUSTER}"][g]
                      for g in ("params", "adam m", "naturals"))

    state, prior, x = setup(**full, data=train)
    n = x.shape[0]
    t_kernel, t_plain = 500, 20
    big, small = stack(x, t_kernel, 64, 3), stack(x, t_plain, 64, 4)
    kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=n, num_samples=4)
    cluster_ms = {c: time_per_step(
        lambda: flexstep.train_chunk(state, prior, big, cluster=c, **kw), t_kernel)
        for c in flexstep.CLUSTER_SIZES}
    kernel_ms = cluster_ms[flexstep.DEFAULT_CLUSTER]
    plain_ms = time_per_step(lambda: flexstep.train_chunk_plain(state, prior, small, **kw),
                             t_plain)
    # The bound, per step: the decoder MLP over K·S·M rows (backward to z)
    # and the encoder over M rows — the combine's O(M·K·(d³ + S·d²)) work
    # is under 1% of it and not counted; the batch read per step, the
    # parameters, both moments and the naturals once per chunk.
    p_flex = n_params(state.nn_params)
    d, d_in, k, s, m = (full[key] for key in ("d", "d_in", "k", "s", "m"))
    flex_bound = bound(
        2 * step_fmas(d, d_in, k, s, m, full["hidden"][0]),
        4 * m * d_in + 4 * (6 * p_flex + 3 * k * (3 + d + d * d)) / t_kernel + 16)
    print(f"phase A: per step on the card at auto width: kernel {kernel_ms:.4f} ms "
          f"(chunks of {t_kernel}, cluster of {flexstep.DEFAULT_CLUSTER}; by cluster size "
          + ", ".join(f"{c}: {v:.4f} ms" for c, v in cluster_ms.items())
          + f"), plain {plain_ms:.4f} ms (chunks of {t_plain}); "
          f"bound {flex_bound[0] * 1e3:.3f} us ({flex_bound[1]}); {card}")

    # B. the auto-svae main path, at the config's nn_precision "default":
    # flexstep's bf16-product mode
    argv = ["--config", "auto-svae", "--steps", "1000", "--device", "cuda", "--seed", "0"]
    flexstep.launches = flexstep.launches_bf16 = 0
    run1 = train_svae.main(argv)
    launches_bf16 = flexstep.launches_bf16
    assert run1["kernel"] == "flexstep" and launches_bf16 >= 2 and flexstep.launches == 0, \
        f"flexstep launched {launches_bf16} times in its bf16 mode on the auto-svae main path"
    rows = run1["rows"]
    assert len(rows) == 2 and all(math.isfinite(v) for r in rows for v in r.values()), rows
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run1["state"]))
    start, end = run1["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    iw = run1["final_test_iw_loglik_per_point"]
    assert math.isfinite(iw)
    run2 = train_svae.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(run1["state"]), leaves(run2["state"]))), \
        "two auto-svae runs at one seed differ"
    # Quality, as restarts: every seed's test ELBO/pt rises by more than 4
    # nats and the best of seeds 0-3 ends above -12.3 (the bar of
    # tests/test_auto_quality_pin.py, measured there at one JAX key; the
    # reference's own entry lands at -12.31..-12.58 over its seeds 0-3, so
    # one seed of another RNG clears it only by chance — PERF.md).
    ends = {0: end}
    for seed in (1, 2, 3):
        out = train_svae.main([*argv[:-1], str(seed), "--iw-samples", "0"])
        ends[seed] = out["rows"][-1]["test_elbo_per_point"]
        assert ends[seed] > out["init_test_elbo_per_point"] + 4.0, \
            f"seed {seed}: test ELBO/pt barely moved to {ends[seed]}"
    assert end > start + 4.0, f"test ELBO/pt barely moved: {start} -> {end}"
    assert max(ends.values()) > -12.3, f"auto-svae quality over seeds 0-3: {ends} (pin -12.3)"
    # The f32 mode on the same path: --nn-precision highest.
    flexstep.launches = flexstep.launches_bf16 = 0
    run_f32 = train_svae.main([*argv, "--nn-precision", "highest", "--iw-samples", "0"])
    launches = flexstep.launches
    assert launches >= 2 and flexstep.launches_bf16 == 0, \
        f"flexstep launched {launches} times in its f32 mode"
    plain = train_svae.main(["--config", "auto-svae", "--steps", "50", "--device", "cuda",
                             "--engine", "plain", "--iw-samples", "0"])
    print(f"phase B: auto-svae at --nn-precision highest (f32): {launches} flexstep "
          f"launches, {run_f32['steps_per_s']:.1f} steps/s, test ELBO/pt -> "
          f"{run_f32['rows'][-1]['test_elbo_per_point']:.4f}; {card}")
    print(f"phase B: auto-svae main path (nn_precision default: bf16 products): "
          f"{launches_bf16} flexstep launches (each one cluster "
          f"of {flexstep.DEFAULT_CLUSTER} CTAs), kernel "
          f"{run1['steps_per_s']:.1f} steps/s, plain {plain['steps_per_s']:.1f} steps/s "
          f"(50 steps), test ELBO/pt {start:.4f} -> {end:.4f}, IW/pt {iw:.4f}, ends over "
          f"seeds 0-3 {[round(v, 4) for v in ends.values()]}, "
          f"synthetic data {run1['meta']['synthetic']}, runs bit-equal; {card}")
    return {"name": "flexstep", "route": "cuda", "source": "svax_torch/ops/csrc/flexstep.cu",
            "replaces": "svax/ops/flexstep_pallas.py:374", "launches": launches,
            "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": flex_bound[0], "bound_by": flex_bound[1], "library_ms": None,
            "cluster": flexstep.DEFAULT_CLUSTER}, launches_bf16


def combine_phase(card: str) -> list:
    """Phase C; returns the combine_forward and combine_backward entries of
    the kernels line (at the mnist shape, without launches)."""
    import numpy as np
    import torch

    from svax_torch.measure_mnist import combine_bound, combine_inputs
    from svax_torch.models import svae
    from svax_torch.ops import combine
    from svax_torch.pgm import gmm

    combine_ptxas("C")

    dev = torch.device("cuda", 0)
    value_tol = {"z": 2e-5, "log_resp": 2e-5, "mean": 2e-5, "local": 2e-4, "stats": 2e-4}
    fields = ["pot_h", "pot_p", *gmm.GmmExpected._fields]

    def outputs(out):
        z, lr, mean, local, st = out
        return {"z": z, "log_resp": lr, "mean": mean, "local": local,
                "stats": torch.cat([st.counts[:, None], st.mean_stat,
                                    st.scatter_stat.flatten(1)], dim=1)}

    def grads(fn, pot_h, pot_p, exp, cts):
        leaves = [t.detach().clone().requires_grad_(True) for t in (pot_h, pot_p, *exp)]
        outs = outputs(fn(leaves[0], leaves[1], gmm.GmmExpected(*leaves[2:])))
        loss = sum((outs[name] * ct).sum() for name, ct in cts.items())
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    def pot_grads(fn, pot_h, pot_p, exp, cts):
        """Configuration (a), the train step's: the potentials only."""
        leaves = [t.detach().clone().requires_grad_(True) for t in (pot_h, pot_p)]
        outs = outputs(fn(leaves[0], leaves[1], exp))
        loss = sum((outs[name] * ct).sum() for name, ct in cts.items())
        return torch.autograd.grad(loss, leaves)

    entries = []
    # "bigk data shard": one rank's combine on phase I's 2x1 data mesh.
    for label, (n, k, d, s) in (("mnist", (256, 10, 8, 1)), ("bigk", (1024, 100, 10, 1)),
                                ("bigk data shard", (512, 100, 10, 1))):
        pot_h, pot_p, exp, eps = combine_inputs(dev, n, k, d, s)
        got = outputs(combine.combine_fused(pot_h, pot_p, exp, eps, s, scale=2.5))
        torch.cuda.synchronize()
        want = outputs(combine.combine_fused_plain(pot_h, pot_p, exp, eps, s, scale=2.5))
        e_val = {name: close(f"combine {label} {name}", got[name], want[name], tol, tol)
                 for name, tol in value_tol.items()}
        rng = np.random.default_rng(1)
        cts = {name: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32,
                                  device=dev) for name, t in want.items()}
        kern = lambda a, b, e: combine.combine_fused(a, b, e, eps, s)  # noqa: E731
        plain = lambda a, b, e: combine.combine_fused_plain(a, b, e, eps, s)  # noqa: E731
        e_grad = e_grad_abs = 0.0
        for paths in [list(cts)] + [[name] for name in cts]:
            sub = {name: cts[name] for name in paths}
            for g, w, what in zip(grads(kern, pot_h, pot_p, exp, sub),
                                  grads(plain, pot_h, pot_p, exp, sub), fields):
                if w is None:
                    assert g is None or float(g.abs().max()) == 0.0, (label, what, paths)
                    continue
                # A field the path does not reach gets exact zeros on both sides.
                scale = float(w.abs().max())
                err = close(f"combine {label} d{what} via {paths}", g, w, 5e-4, 5e-4 * scale)
                e_grad = max(e_grad, err / scale) if scale > 0 else e_grad
                e_grad_abs = max(e_grad_abs, err)
        twice = [grads(lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=7,
                                                             step=3), pot_h, pot_p, exp, cts)
                 for _ in range(2)]
        assert all(torch.equal(a_, b_) for a_, b_ in zip(*twice)), f"{label}: reruns differ"
        # Configuration (a): the cotangents of z, log r̃ and the local row,
        # no dw — combine_bwd_lean.
        main = {name: cts[name] for name in ("z", "log_resp", "local")}
        lean0 = combine.lean_backward_launches
        e_lean = 0.0
        for g, w, what in zip(pot_grads(kern, pot_h, pot_p, exp, main),
                              pot_grads(plain, pot_h, pot_p, exp, main), fields):
            scale = float(w.abs().max())
            err = close(f"combine {label} (a) d{what}", g, w, 5e-4, 5e-4 * scale)
            e_lean = max(e_lean, err / scale)
            e_grad_abs = max(e_grad_abs, err)
        assert combine.lean_backward_launches == lean0 + 1, f"{label}: (a) did not run lean"
        twice = [pot_grads(lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=7,
                                                                 step=3), pot_h, pot_p, exp, main)
                 for _ in range(2)]
        assert all(torch.equal(a_, b_) for a_, b_ in zip(*twice)), f"{label}: (a) reruns differ"
        again = outputs(combine.combine_fused(pot_h, pot_p, exp, eps, s, scale=2.5))
        assert all(torch.equal(got[name], again[name]) for name in got), label

        # The in-kernel ε, recovered as L̃ᵀ(z − μ̃).
        z = combine.combine_fused(pot_h, pot_p, exp, None, s, seed=11, step=5)[0]
        post = svae.sin_combine(pot_h.double(), pot_p.double(),
                                gmm.GmmExpected(*(t.double() for t in exp)))
        rec = (post.prec_chol.mT @ (z[0].double() - post.mean)[..., None])[..., 0]
        mean, var = float(rec.mean()), float(rec.var())
        if label == "bigk":  # 1,024,000 draws (mnist: 20,480)
            assert abs(mean) < 0.005 and abs(var - 1.0) < 0.01, (label, mean, var)
        assert torch.equal(z, combine.combine_fused(pot_h, pot_p, exp, None, s, seed=11,
                                                    step=5)[0])
        assert not torch.equal(z, combine.combine_fused(pot_h, pot_p, exp, None, s,
                                                        seed=11, step=6)[0])
        assert not torch.equal(z, combine.combine_fused(pot_h, pot_p, exp, None, s,
                                                        seed=12, step=5)[0])
        sub = {"z": cts["z"], "log_resp": cts["log_resp"], "local": cts["local"]}
        e_rng = 0.0
        for g, w, what in zip(
                grads(lambda a, b, e: combine.combine_fused(a, b, e, None, s, seed=11, step=5),
                      pot_h, pot_p, exp, sub),
                grads(lambda a, b, e: combine.combine_fused(a, b, e, rec[None].float(), s),
                      pot_h, pot_p, exp, sub), fields):
            scale = float(w.abs().max())
            err = close(f"combine {label} seeded d{what}", g, w, 5e-4, 5e-4 * scale)
            e_rng = max(e_rng, err / scale) if scale > 0 else e_rng

        line = (f"phase C: combine vs plain at {label} N={n} K={k} d={d} S={s}: "
                + ", ".join(f"{name} max abs err {v:.3e}" for name, v in e_val.items())
                + f" (bars {value_tol}); gradients, 5 paths alone and together (b) and the "
                f"train step's (a), max abs err {e_grad_abs:.3e}, / max|grad| {e_grad:.3e} "
                f"(b), {e_lean:.3e} (a) (bar 5e-4); reruns bit-equal; "
                f"in-kernel eps recovered: mean {mean:.5f} var {var:.5f}, same seed "
                f"bit-equal, seeded vs injected gradients {e_rng:.3e}")
        if label == "bigk data shard":
            print(f"{line}; {card}", flush=True)
            continue
        t = timed_fresh("time_combine", n, k, d, s)
        fb, bb = combine_bound(n, k, d, s, False), combine_bound(n, k, d, s, True)
        ab = combine_bound(n, k, d, s, True, main_path=True)
        print(f"{line}; " + combine_times_line(t, "", fb, ab, bb) + f"; {card}", flush=True)
        if label == "mnist":
            entries = [
                {"name": "combine_forward", "route": "cuda",
                 "source": "svax_torch/ops/csrc/combine.cu",
                 "replaces": "svax/ops/combine_pallas.py:431", "max_abs_err": max(e_val.values()),
                 "ms": t["kernel_fwd_device"], "plain_ms": t["plain_fwd_device"],
                 "bound_ms": fb[0], "bound_by": fb[1], "library_ms": None,
                 "kernel_ms": t["kernel_fwd_kernel"], "reduce_ms": t["kernel_fwd_reduce"]},
                {"name": "combine_backward", "route": "cuda",
                 "source": "svax_torch/ops/csrc/combine_bwd.cu",
                 "replaces": "svax/ops/combine_pallas.py:588", "max_abs_err": e_grad_abs,
                 "ms": t["kernel_bwd_a_device"], "plain_ms": t["plain_bwd_a_device"],
                 "bound_ms": ab[0], "bound_by": ab[1], "library_ms": None,
                 "full_ms": t["kernel_bwd_b_device"], "full_plain_ms": t["plain_bwd_b_device"],
                 "full_bound_ms": bb[0],
                 "full_source": "svax_torch/ops/csrc/combine_bwd_full.cu"},
            ]
    return entries


def mnist_phase(card: str, bundle: str) -> tuple[tuple[int, int], dict]:
    """Phase D; returns the combine forward and backward launches of the
    main path's first run (seed 0), and that run's purity and IW bound,
    whose final state it writes as a serving bundle to ``bundle`` (phase L)."""
    import torch

    from svax_torch import train_svae
    from svax_torch.measure_mnist import profile_entry, quality
    from svax_torch.ops import combine

    launches, lines, served = None, [], {}
    for seed in (0, 1):
        argv = ["--config", "mnist-svae", "--steps", "2000", "--device", "cuda",
                "--seed", str(seed), "--iw-samples", "100" if seed == 0 else "0"]
        if seed == 0:
            argv += ["--bundle-dir", bundle]
        combine.launches = combine.backward_launches = combine.lean_backward_launches = 0
        combine.backward_paths.clear()
        run1 = train_svae.main(argv)
        fwd, bwd = combine.launches, combine.lean_backward_launches
        assert run1["kernel"] == "per-step" and fwd > 0 and bwd > 0, \
            f"combine launched {fwd} / {bwd} times on the mnist-svae main path"
        # The train step's backward is combine_bwd_lean's call: z̄, lr̄, local̄.
        assert combine.backward_launches == bwd and set(combine.backward_paths) == {
            "dz+dlr+dlocal"}, (combine.backward_launches, combine.backward_paths)
        if launches is None:
            launches = (fwd, bwd)
        rows = run1["rows"]
        assert len(rows) == 10 and all(math.isfinite(v) for r in rows for v in r.values())
        assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run1["state"]))
        if seed == 0:
            # Bit-equality on a pair of shorter runs (200 warmup + 400 steps,
            # the same path's kernels), which pays for phase N; the full
            # runs hold the floors.
            short = ["--config", "mnist-svae", "--steps", "400", "--warmup-steps", "200",
                     "--device", "cuda", "--seed", "0", "--iw-samples", "0"]
            run2, run3 = train_svae.main(short), train_svae.main(short)
            assert all(torch.equal(p, q) for p, q in
                       zip(leaves(run2["state"]), leaves(run3["state"]))), \
                f"two mnist-svae runs at seed {seed} differ"
        start, end = run1["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
        purity, used = quality(run1, seed)
        if seed == 0:
            served = {"bundle": bundle, "purity": purity, "state": run1["state"],
                      "iw": run1["final_test_iw_loglik_per_point"]}
        lines.append(f"seed {seed}: {fwd} forward / {bwd} backward combine launches (the "
                     f"backward's cotangents {combine.backward_paths}), "
                     f"warmup {run1['warmup']['seconds']:.1f} s (seed occupancy "
                     f"{run1['warmup']['seed_occupancy']}), {run1['steps_per_s']:.1f} "
                     f"steps/s, test ELBO/pt {start:.4f} -> {end:.4f}, purity {purity:.4f}, "
                     f"{used} of 10 components in use"
                     + (f", IW/pt {run1['final_test_iw_loglik_per_point']:.4f}, two runs "
                        "of 200 warmup + 400 steps bit-equal" if seed == 0 else ""))
        assert end > start + 100.0, f"seed {seed}: test ELBO/pt {start} -> {end}"
        assert purity > 0.7, f"seed {seed}: cluster purity {purity}"
        assert used >= 6, f"seed {seed}: only {used} of 10 components in use"
    print(f"phase D: mnist-svae main path (synthetic data "
          f"{run1['meta']['synthetic']}): " + "; ".join(lines) + f"; {card}", flush=True)
    plain = train_svae.main(["--config", "mnist-svae", "--steps", "40", "--warmup-steps",
                             "0", "--device", "cuda", "--engine", "plain",
                             "--iw-samples", "0"])
    print(f"phase D: mnist-svae plain engine: {plain['steps_per_s']:.1f} steps/s (40 steps, "
          f"no warmup); {card}", flush=True)
    # The plain engine's profile cut to 3 steps: its thousands of events a
    # step cost ~3 s a step of host time to read back (phase Q pays for it).
    for engine, steps in (("kernel", 50), ("plain", 3)):
        r = profile_entry(["--config", "mnist-svae", "--steps", str(steps), "--warmup-steps",
                           "0", "--device", "cuda", "--engine", engine, "--iw-samples", "0"])
        print(f"phase D: mnist-svae {engine} engine, {steps} steps under torch.profiler: "
              f"{r['steps_per_s']:.1f} steps/s, wall {r['wall_ms']:.1f} ms, device "
              f"{r['device_ms']:.3f} ms, idle share {100 * r['idle']:.1f}%, combine "
              f"kernels {r['combine_ms']:.3f} ms ({100 * r['combine_ms'] / r['device_ms']:.1f}%"
              f" of device time); {card}", flush=True)
    return launches, served


def decoder_phase(card: str) -> list:
    """Phase E; returns the decoder_mlp_forward and decoder_mlp_backward
    entries of the kernels line (at the bigk shape, without launches)."""
    import torch

    from svax_torch.measure_mnist import (DECODER_FIELDS, DECODER_TOL, decoder_bound,
                                          decoder_errors, decoder_grads, decoder_inputs,
                                          sm_clock_hz, time_decoder)
    from svax_torch.ops import decoder_mlp

    dev = torch.device("cuda", 0)
    clock = sm_clock_hz()
    # The shard shapes are one rank's decoder on phase I's 1x2 comp mesh (50
    # rows a point) and 2x1 data mesh.
    shapes = {"bigk": (1, 1024, 100, 10, 200, 200, 784), "mnist": (1, 256, 10, 8, 200, 200, 784),
              "ragged": (1, 37, 7, 3, 24, 40, 50),
              "bigk comp shard": (1, 1024, 50, 10, 200, 200, 784),
              "bigk data shard": (1, 512, 100, 10, 200, 200, 784)}
    entries = []
    for label, shape in shapes.items():
        params, z, x, dll = decoder_inputs(dev, *shape)
        e = decoder_errors(params, z, x, dll)
        bars = [("ll", DECODER_TOL["ll"]), ("ll share > 1e-5", DECODER_TOL["ll share > 1e-5"]),
                ("dz max", DECODER_TOL["dz max"]),
                ("dz share > 1e-5", DECODER_TOL["dz share > 1e-5"])] + [
                    (name, DECODER_TOL["grad"]) for name in DECODER_FIELDS[1:]]
        bad = [(name, e[name], bar) for name, bar in bars if not e[name] < bar]
        assert e["finite"] and not bad, f"decoder_mlp {label} {shape}: {bad} ({e})"
        twice = [decoder_grads(decoder_mlp.core_fused, params, z, x, dll) for _ in range(2)]
        assert torch.equal(twice[0][0], twice[1][0]), f"decoder_mlp {label}: forward reruns differ"
        assert all(torch.equal(twice[0][1][n], twice[1][1][n]) for n in DECODER_FIELDS), \
            f"decoder_mlp {label}: backward reruns differ"
        line = (f"phase E: decoder_mlp vs plain at {label} S,N,K,d,H1,H2,D={shape}: "
                + ", ".join(f"{k_} {v:.3e}" for k_, v in e.items() if k_ != "finite")
                + f" (bars {DECODER_TOL}); reruns bit-equal")
        if label in ("bigk", "mnist"):
            t = time_decoder(dev, *shape)
            fb, bb = (decoder_bound(*shape, backward=b, sm_clock_hz=clock) for b in (False, True))
            unfused_bwd = t["unfused_fwdbwd"] - t["unfused_fwd"]
            both = t["kernel_fwd"] + t["kernel_bwd"]
            line += (f"; CUDA-event ms per call: forward {t['kernel_fwd']:.4f} (plain "
                     f"{t['plain_fwd']:.4f}, unfused bf16 {t['unfused_fwd']:.4f}), backward "
                     f"{t['kernel_bwd']:.4f} (plain {t['plain_bwd']:.4f}, unfused bf16 "
                     f"{unfused_bwd:.4f}: {'no slower' if t['kernel_bwd'] <= unfused_bwd else 'slower'}), "
                     f"forward + backward {both:.4f} (unfused bf16 {t['unfused_fwdbwd']:.4f}: "
                     f"{'no slower' if both <= t['unfused_fwdbwd'] else 'slower'}); "
                     f"bound forward {fb['ms'] * 1e3:.2f} us ({fb['by']}: products "
                     f"{fb['products_ms'] * 1e3:.2f}, special functions "
                     f"{fb['special_ms'] * 1e3:.2f} at {clock / 1e6:.0f} MHz, bytes "
                     f"{fb['bytes_ms'] * 1e3:.2f}; the forward at "
                     f"{fb['ms'] / t['kernel_fwd']:.1%} of it), backward {bb['ms'] * 1e3:.2f} us "
                     f"({bb['by']}: products {bb['products_ms'] * 1e3:.2f}, special functions "
                     f"{bb['special_ms'] * 1e3:.2f}, bytes {bb['bytes_ms'] * 1e3:.2f})")
        print(line + f"; {card}", flush=True)
        if label == "bigk":
            common = {"route": "cuda", "source": "svax_torch/ops/csrc/decoder_mlp.cu",
                      "library_ms": None}
            entries = [
                {"name": "decoder_mlp_forward", **common,
                 "replaces": "svax/ops/decoder_mlp_pallas.py:99", "max_abs_err": e["ll max abs"],
                 "ms": t["kernel_fwd"], "plain_ms": t["plain_fwd"],
                 "bound_ms": fb["ms"], "bound_by": fb["by"], "special_ms": fb["special_ms"],
                 "unfused_bf16_ms": t["unfused_fwd"]},
                {"name": "decoder_mlp_backward", **common,
                 "replaces": "svax/ops/decoder_mlp_pallas.py:205",
                 "max_abs_err": e["grad max abs"], "ms": t["kernel_bwd"],
                 "plain_ms": t["plain_bwd"], "bound_ms": bb["ms"], "bound_by": bb["by"],
                 "special_ms": bb["special_ms"], "unfused_bf16_ms": unfused_bwd},
            ]
    forward_ptxas("decoder_fwd", "E")
    return entries


def bigk_phase(card: str) -> tuple[tuple[int, int], float]:
    """Phase F; returns the decoder forward and backward launches of the
    bigk-dp main path's first run, and its ms a step."""
    import torch

    from svax_torch import train_svae
    from svax_torch.measure_mnist import profile_entry, quality
    from svax_torch.ops import combine, decoder_mlp

    argv = ["--config", "bigk-dp", "--warmup-steps", "300", "--steps", "600", "--device",
            "cuda", "--seed", "0", "--iw-samples", "0"]
    decoder_mlp.launches = decoder_mlp.backward_launches = 0
    combine.launches = combine.backward_launches = combine.lean_backward_launches = 0
    combine.backward_paths.clear()
    run1 = train_svae.main(argv)
    launches = (decoder_mlp.launches, decoder_mlp.backward_launches)
    comb = (combine.launches, combine.lean_backward_launches)
    assert run1["kernel"] == "per-step" and min(launches) > 0 and min(comb) > 0, \
        f"bigk-dp main path: decoder {launches}, combine {comb} launches"
    paths = dict(combine.backward_paths)
    assert combine.backward_launches == comb[1] and set(paths) == {"dz+dlr+dlocal"}, paths
    rows = run1["rows"]
    assert [r["step"] for r in rows] == [1, 200, 400, 600], [r["step"] for r in rows]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run1["state"]))
    run2 = train_svae.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(run1["state"]), leaves(run2["state"]))), "two bigk-dp runs differ"
    start, end = run1["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    purity, used = quality(run1, 0)
    print(f"phase F: bigk-dp main path (300 warmup + 600 joint steps of the config's 1000 + "
          f"5000, seed 0; synthetic data {run1['meta']['synthetic']}): decoder "
          f"{launches[0]} forward / {launches[1]} backward launches, combine {comb[0]} / "
          f"{comb[1]} (the backward's cotangents {paths}), warmup "
          f"{run1['warmup']['seconds']:.1f} s (seed occupancy "
          f"{run1['warmup']['seed_occupancy']}), {run1['steps_per_s']:.1f} steps/s, test "
          f"ELBO/pt {start:.4f} -> {end:.4f}, purity {purity:.4f}, {used} of 100 components "
          f"in use, runs bit-equal; {card}", flush=True)
    assert end > start + 100.0, f"bigk-dp: test ELBO/pt {start} -> {end}"
    assert purity > 0.7, f"bigk-dp: cluster purity {purity}"
    assert used >= 6, f"bigk-dp: only {used} of 100 components in use"
    plain = train_svae.main(["--config", "bigk-dp", "--steps", "10", "--warmup-steps", "0",
                             "--device", "cuda", "--engine", "plain", "--iw-samples", "0"])
    print(f"phase F: bigk-dp plain engine: {plain['steps_per_s']:.1f} steps/s (10 steps, no "
          f"warmup); {card}", flush=True)
    r = profile_entry(["--config", "bigk-dp", "--steps", "50", "--warmup-steps", "0",
                       "--device", "cuda", "--engine", "kernel", "--iw-samples", "0"])
    print(f"phase F: bigk-dp kernel engine, 50 steps under torch.profiler: "
          f"{r['steps_per_s']:.1f} steps/s, wall {r['wall_ms']:.1f} ms, device "
          f"{r['device_ms']:.3f} ms, idle share {100 * r['idle']:.1f}%, decoder kernels "
          f"{r['decoder_ms']:.3f} ms ({100 * r['decoder_ms'] / r['device_ms']:.1f}% of device "
          f"time), combine kernels {r['combine_ms']:.3f} ms "
          f"({100 * r['combine_ms'] / r['device_ms']:.1f}%); {card}", flush=True)
    return launches, 1e3 / run1["steps_per_s"]


def smm_combine_ops(rounds: int, envelope: bool) -> int:
    """Operations of the SMM branch's u–z combine per (n, k) beyond the GMM
    combine: ~30 per z-update with its Q_nk, R rounds and the Student-t
    terms (~40) forward; backward ~40 a round plus R(R−1)/2 recomputed
    z-updates in the full chain, none in the envelope mode."""
    fwd = 30 * rounds + 40
    bwd = 0 if envelope else 40 * rounds + 30 * rounds * (rounds - 1) // 2
    return fwd + bwd


def smm_phase(card: str) -> dict:
    """Phase G; returns the tinystep_smm entry of the kernels line."""
    import numpy as np
    import torch

    from svax_torch import train_svae
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.measure_auto import mlp_fmas
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import tinystep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    dev = torch.device("cuda", 0)
    train, _ = load_pinwheel(seed=0)
    n, k, s, t = train.shape[0], 10, 4, 3
    x = torch.tensor(train, dtype=torch.float32, device=dev)

    def setup(hidden):
        config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
        prior = gmm.make_prior(k, 2, kappa=0.05)
        state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                     hidden, hidden)
        return svae_step.state_to(state, dev), svae_step.nat_to(prior, dev)

    rng = np.random.default_rng(200)
    eps = torch.tensor(rng.standard_normal((t, s, n, k, 2)), dtype=torch.float32,
                       device=dev)
    aug_eps = torch.tensor(rng.standard_normal((t, n, 2)), dtype=torch.float32, device=dev)
    cases = [("dof 4, 2 rounds, full chain, 50-50", (50, 50),
              dict(dof=4.0, smm_iters=2, smm_envelope_grads=False)),
             ("dof 4, 2 rounds, envelope, 50-50", (50, 50),
              dict(dof=4.0, smm_iters=2, smm_envelope_grads=True)),
             ("dof 2.5, 1 round, full chain, 16-16", (16, 16),
              dict(dof=2.5, smm_iters=1, smm_envelope_grads=False))]
    errs = {}
    for name, hidden, smm in cases:
        state, prior = setup(hidden)
        kw = dict(lr=1e-3, rho=0.05, t_steps=t, aug_noise=0.4, eps=eps, aug_eps=aug_eps,
                  **smm)
        st_k, met_k = tinystep.train_chunk(state, prior, x, **kw)
        torch.cuda.synchronize()
        st_p, met_p = tinystep.train_chunk_plain(state, prior, x, **kw)
        e = {}
        for group, tk, tp, rtol, atol in (
                ("params", st_k.nn_params, st_p.nn_params, 5e-4, 5e-5),
                ("adam m", st_k.opt_state.mu, st_p.opt_state.mu, 5e-4, 5e-6),
                ("adam v", st_k.opt_state.nu, st_p.opt_state.nu, 5e-4, 1e-8)):
            e[group] = max(close(f"tinystep smm {name} {group}", a_, b_, rtol, atol)
                           for a_, b_ in zip(flat(tk), flat(tp)))
        e["naturals"] = max(close(f"tinystep smm {name} naturals", a_, b_, 2e-5, 2e-5)
                            for a_, b_ in zip(nat_leaves(st_k.pgm_nat),
                                              nat_leaves(st_p.pgm_nat)))
        e["recon"] = close(f"tinystep smm {name} recon", met_k["recon"], met_p["recon"],
                           2e-4, 0.0)
        e["local_kl"] = close(f"tinystep smm {name} local_kl", met_k["local_kl"],
                              met_p["local_kl"], 2e-4, 2e-4)
        assert st_k.step == st_p.step == t and st_k.opt_state.count == t
        errs[name] = e
        print(f"phase G: tinystep SMM (one cluster of {tinystep.DEFAULT_CLUSTER} CTAs) vs "
              f"plain, T={t} at N={n} K={k} S={s} sigma=0.4, "
              f"{name}: " + ", ".join(f"{g} max abs err {v:.3e}" for g, v in e.items())
              + " (phase 4's tolerances)", flush=True)
    max_abs_err = max(e[g] for e in errs.values()
                      for g in ("params", "adam m", "adam v", "naturals"))

    # Per step at full width: both gradient modes and the GMM branch in one
    # call, in turns, then the plain SMM step.
    state, prior = setup((50, 50))
    t_kernel, t_plain = 200, 20
    base = dict(lr=1e-3, rho=0.05, aug_noise=0.4)
    modes = {"gmm": {}, "smm full chain": dict(dof=4.0, smm_iters=2),
             "smm envelope": dict(dof=4.0, smm_iters=2, smm_envelope_grads=True)}
    times = {name: [] for name in modes}
    for _ in range(2):
        for name, smm in modes.items():
            times[name].append(time_per_step(
                lambda: tinystep.train_chunk(state, prior, x, t_steps=t_kernel, **base,
                                             **smm), t_kernel))
    plain_ms = time_per_step(
        lambda: tinystep.train_chunk_plain(state, prior, x, t_steps=t_plain, dof=4.0,
                                           smm_iters=2, **base), t_plain)
    ms = {name: min(v) for name, v in times.items()}
    p_tiny = n_params(state.nn_params)
    mlp = 2 * (mlp_fmas([2, 50, 50, 4], s * n * k, True) + mlp_fmas([2, 50, 50, 4], n, False))
    nbytes = 4 * (6 * p_tiny + 2 * n + 3 * k * 9) / t_kernel + 12
    smm_bound = bound(mlp + n * k * smm_combine_ops(2, False), nbytes)
    env_bound = bound(mlp + n * k * smm_combine_ops(2, True), nbytes)
    print(f"phase G: per step on the card (chunks of {t_kernel}, best of 2 turns, each the "
          f"median of 3): SMM full chain {ms['smm full chain']:.4f} ms "
          f"{[round(v, 4) for v in times['smm full chain']]}, SMM envelope "
          f"{ms['smm envelope']:.4f} ms {[round(v, 4) for v in times['smm envelope']]}, GMM "
          f"{ms['gmm']:.4f} ms {[round(v, 4) for v in times['gmm']]}; plain SMM step "
          f"{plain_ms:.4f} ms (chunks of {t_plain}); bound full chain "
          f"{smm_bound[0] * 1e3:.3f} us, envelope {env_bound[0] * 1e3:.3f} us "
          f"({smm_bound[1]}); {card}", flush=True)

    # The SMM main path, then the per-step engine under --smm-dof.
    # At --nn-precision highest: tinystep's f32 mode, this phase's kernel
    # (phase M runs the config's bf16-product mode under --smm-dof).
    argv = ["--config", "pinwheel-svae", "--smm-dof", "4", "--steps", "2000", "--device",
            "cuda", "--seed", "0", "--nn-precision", "highest"]
    tinystep.launches = 0
    run1 = train_svae.main(argv)
    launches = tinystep.launches
    assert run1["kernel"] == "tinystep" and launches >= 2, \
        f"tinystep launched {launches} times on the SMM main path"
    rows = run1["rows"]
    assert len(rows) == 2 and all(math.isfinite(v) for r in rows for v in r.values()), rows
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run1["state"]))
    assert rows[-1]["elbo"] > rows[0]["elbo"], "SMM training ELBO did not improve"
    start, end = run1["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    assert end > start, f"SMM test ELBO/pt did not rise: {start} -> {end}"
    iw = run1["final_test_iw_loglik_per_point"]
    assert math.isfinite(iw)
    run2 = train_svae.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(run1["state"]), leaves(run2["state"]))), \
        "two SMM pinwheel runs at one seed differ"
    auto_argv = ["--config", "auto-svae", "--smm-dof", "4", "--steps", "50", "--device",
                 "cuda", "--seed", "0", "--iw-samples", "0"]
    auto1 = train_svae.main(auto_argv)
    assert auto1["kernel"] == "per-step" and "GMM prior only" in auto1["why"], auto1["why"]
    assert all(math.isfinite(v) for r in auto1["rows"] for v in r.values())
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(auto1["state"]))
    auto2 = train_svae.main(auto_argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(auto1["state"]), leaves(auto2["state"]))), \
        "two SMM auto-svae runs at one seed differ"
    print(f"phase G: SMM main path (pinwheel-svae --smm-dof 4, 2000 steps): {launches} "
          f"tinystep launches (each one cluster of {tinystep.DEFAULT_CLUSTER} CTAs), "
          f"{run1['steps_per_s']:.1f} steps/s, training ELBO "
          f"{rows[0]['elbo']:.4f} -> {rows[-1]['elbo']:.4f}, test ELBO/pt {start:.4f} -> "
          f"{end:.4f}, SMM IW/pt {iw:.4f}, runs bit-equal; auto-svae --smm-dof 4 (per-step "
          f"engine, 50 steps): {auto1['steps_per_s']:.1f} steps/s, test ELBO/pt "
          f"{auto1['init_test_elbo_per_point']:.4f} -> "
          f"{auto1['rows'][-1]['test_elbo_per_point']:.4f}, runs bit-equal; {card}",
          flush=True)
    return {"name": "tinystep_smm", "route": "cuda",
            "source": "svax_torch/ops/csrc/tinystep.cu",
            "replaces": "svax/ops/tinystep_pallas.py:621", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms["smm full chain"], "plain_ms": plain_ms,
            "bound_ms": smm_bound[0], "bound_by": smm_bound[1], "library_ms": None,
            "envelope_ms": ms["smm envelope"], "gmm_ms_same_call": ms["gmm"],
            "cluster": tinystep.DEFAULT_CLUSTER}


def rho_phase(card: str) -> list:
    """Phase H; returns the log_rho_fwd, log_rho_bwd, combine_fwd_norm and
    combine_bwd_norm entries of the kernels line (times at the bigk K-shard,
    without launches)."""
    import numpy as np
    import torch

    from svax_torch.measure_mnist import combine_bound, combine_inputs, rho_bound
    from svax_torch.ops import combine
    from svax_torch.pgm import gmm

    dev = torch.device("cuda", 0)
    value_tol = {"z": 2e-5, "log_resp": 2e-5, "mean": 2e-5, "local": 2e-4, "stats": 2e-4}
    fields = ["pot_h", "pot_p", *gmm.GmmExpected._fields, "log_norm"]

    def outputs(out):
        z, lr, mean, local, st = out
        return {"z": z, "log_resp": lr, "mean": mean, "local": local,
                "stats": torch.cat([st.counts[:, None], st.mean_stat,
                                    st.scatter_stat.flatten(1)], dim=1)}

    def shard(exp, i, count):
        k = exp.log_pi.shape[0] // count
        return gmm.GmmExpected(*(t[i * k:(i + 1) * k] for t in exp))

    def grads(fn, tensors, loss_of):
        leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
        return torch.autograd.grad(loss_of(fn(*leaves)), leaves, allow_unused=True)

    def held(what, got, want, bar):
        """Each gradient within ``bar`` of its largest entry; returns the
        largest absolute error."""
        err = 0.0
        for g, w, name in zip(got, want, fields):
            if w is None:
                assert g is None or float(g.abs().max()) == 0.0, (what, name)
                continue
            scale = float(w.abs().max())
            err = max(err, close(f"{what} d{name}", g, w, bar, bar * scale))
        return err

    instances_ptxas("H", "log_rho_fwd", {(d,) for d in combine.LATENT_DIMS})
    instances_ptxas("H", "log_rho_bwd", {(d, dw) for d in combine.LATENT_DIMS for dw in (0, 1)})
    errs = {"log_rho_fwd": 0.0, "log_rho_bwd": 0.0, "combine_fwd_norm": 0.0,
            "combine_bwd_norm": 0.0}
    lines = []
    for label, (n, k, d, s) in (("bigk", (1024, 100, 10, 1)), ("pinwheel", (400, 10, 2, 4))):
        pot_h, pot_p, exp, eps = combine_inputs(dev, n, k, d, s)
        rng = np.random.default_rng(2)
        shards = [shard(exp, i, 2) for i in range(2)]
        # The ρ-kernel, forward and backward, at the full K and each shard.
        for e in [exp, *shards]:
            kk = e.log_pi.shape[0]
            got = combine.log_rho_fused(pot_h, pot_p, e)
            want = combine.log_rho_plain(pot_h, pot_p, e)
            errs["log_rho_fwd"] = max(errs["log_rho_fwd"], close(
                f"log rho {label} K={kk}", got, want, 2e-5, 2e-5))
            assert torch.equal(got, combine.log_rho_fused(pot_h, pot_p, e)), "rho reruns differ"
            # log ρ is the log_norm combine's log r̃ at a zero normaliser, bit for bit.
            lr0 = combine.combine_fused(pot_h, pot_p, e, eps[:, :, :kk].contiguous(), s,
                                        log_norm=torch.zeros(n, device=dev))[1]
            assert torch.equal(got, lr0), f"log rho {label} K={kk} differs from the combine's"
            drho = torch.tensor(rng.standard_normal((n, kk)), dtype=torch.float32, device=dev)
            loss = lambda out: (out * drho).sum()  # noqa: E731
            # (a), the train step's call: the expected parameters constant.
            rho_ka = lambda a, b: combine.log_rho_fused(a, b, e)  # noqa: E731
            rho_pa = lambda a, b: combine.log_rho_plain(a, b, e)  # noqa: E731
            combine.rho_backward_paths.clear()
            ga = grads(rho_ka, (pot_h, pot_p), loss)
            assert combine.rho_backward_paths == {"dpot": 1}, combine.rho_backward_paths
            errs["log_rho_bwd"] = max(errs["log_rho_bwd"], held(
                f"log rho {label} K={kk} (a)", ga, grads(rho_pa, (pot_h, pot_p), loss), 5e-4))
            assert all(torch.equal(a, b) for a, b in
                       zip(ga, grads(rho_ka, (pot_h, pot_p), loss))), "rho bwd (a) reruns differ"
            # (b), every gradient, dw included.
            rho_k = lambda a, b, *f: combine.log_rho_fused(a, b, gmm.GmmExpected(*f))  # noqa: E731
            rho_p = lambda a, b, *f: combine.log_rho_plain(a, b, gmm.GmmExpected(*f))  # noqa: E731
            gk = grads(rho_k, (pot_h, pot_p, *e), loss)
            errs["log_rho_bwd"] = max(errs["log_rho_bwd"], held(
                f"log rho {label} K={kk} (b)", gk, grads(rho_p, (pot_h, pot_p, *e), loss), 5e-4))
            assert all(torch.equal(a, b) for a, b in
                       zip(gk, grads(rho_k, (pot_h, pot_p, *e), loss))), "rho bwd reruns differ"

        # The log_norm combine on one shard against its plain version, the
        # normaliser from both shards' ρ-kernels: values, every cotangent
        # path alone and together (dn among the gradients), reruns.
        lse = torch.logsumexp(torch.cat([combine.log_rho_fused(pot_h, pot_p, e)
                                         for e in shards], dim=1), dim=-1)
        e0, eps0 = shards[0], eps[:, :, :k // 2].contiguous()
        norm_k = lambda a, b, *f: combine.combine_fused(  # noqa: E731
            a, b, gmm.GmmExpected(*f[:-1]), eps0, s, log_norm=f[-1])
        norm_p = lambda a, b, *f: combine.combine_fused_plain(  # noqa: E731
            a, b, gmm.GmmExpected(*f[:-1]), eps0, s, log_norm=f[-1])
        got, want = outputs(norm_k(pot_h, pot_p, *e0, lse)), outputs(norm_p(pot_h, pot_p, *e0, lse))
        for name, tol in value_tol.items():
            errs["combine_fwd_norm"] = max(errs["combine_fwd_norm"], close(
                f"norm combine {label} {name}", got[name], want[name], tol, tol))
        again = outputs(norm_k(pot_h, pot_p, *e0, lse))
        assert all(torch.equal(got[m], again[m]) for m in got), "norm combine reruns differ"
        # Configuration (a), the train step's on a K-shard: the cotangents of
        # z, log r̃ and the local row; the potentials' and dn, no dw.
        main = {m: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32, device=dev)
                for m, t in want.items() if m in ("z", "log_resp", "local")}
        main_loss = lambda out: sum((outputs(out)[m] * main[m]).sum() for m in main)  # noqa: E731
        lean_k = lambda a, b, nrm: norm_k(a, b, *e0, nrm)  # noqa: E731
        lean0 = combine.norm_lean_backward_launches
        gk = grads(lean_k, (pot_h, pot_p, lse), main_loss)
        assert combine.norm_lean_backward_launches == lean0 + 1, "(a) did not run lean"
        errs["combine_bwd_norm"] = max(errs["combine_bwd_norm"], held(
            f"norm combine {label} (a)", gk,
            grads(lambda a, b, nrm: norm_p(a, b, *e0, nrm), (pot_h, pot_p, lse), main_loss),
            5e-4))
        assert all(torch.equal(a, b) for a, b in
                   zip(gk, grads(lean_k, (pot_h, pot_p, lse), main_loss))), "(a) reruns differ"
        cts = {m: torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32, device=dev)
               for m, t in want.items()}
        for paths in [list(cts)] + [[m] for m in cts]:
            loss = lambda out, paths=paths: sum(  # noqa: E731
                (outputs(out)[m] * cts[m]).sum() for m in paths)
            gk = grads(norm_k, (pot_h, pot_p, *e0, lse), loss)
            errs["combine_bwd_norm"] = max(errs["combine_bwd_norm"], held(
                f"norm combine {label} via {paths}", gk,
                grads(norm_p, (pot_h, pot_p, *e0, lse), loss), 5e-4))
            assert all((a is None and b is None) or torch.equal(a, b) for a, b in
                       zip(gk, grads(norm_k, (pot_h, pot_p, *e0, lse), loss))), \
                "norm combine bwd reruns differ"

        # The identity of tests/test_combine_kernel.py:223-262: log_norm =
        # lse(log ρ) reproduces the softmax combine, values and gradients
        # through ρ-kernel → lse → combine.
        def chain(use_norm):
            def fn(a, b, *f):
                e = gmm.GmmExpected(*f)
                nrm = (torch.logsumexp(combine.log_rho_fused(a, b, e), dim=-1)
                       if use_norm else None)
                return combine.combine_fused(a, b, e, eps, s, log_norm=nrm)
            return fn

        def scalar(out):
            z, lr, mean, local, st = out
            return ((torch.exp(lr) * torch.tanh(z).sum(dim=(0, -1))).sum() - local.sum()
                    + 0.01 * st.scatter_stat.sum() + 0.1 * mean.sum())

        a_out = outputs(chain(True)(pot_h, pot_p, *exp))
        b_out = outputs(chain(False)(pot_h, pot_p, *exp))
        for name, tol in value_tol.items():
            close(f"lse(log rho) vs softmax {label} {name}", a_out[name], b_out[name], tol, tol)
        e_id = held(f"lse(log rho) vs softmax {label}", grads(chain(True), (pot_h, pot_p, *exp),
                                                            scalar),
                    grads(chain(False), (pot_h, pot_p, *exp), scalar), 5e-4)

        # Two shards, each its own ρ-kernel, the cross-shard lse, each
        # shard's log_norm combine, against the unsharded combine.
        def sharded(a, b, *f):
            es = [shard(gmm.GmmExpected(*f), i, 2) for i in range(2)]
            nrm = torch.logsumexp(torch.cat([combine.log_rho_fused(a, b, e) for e in es],
                                            dim=1), dim=-1)
            outs = [combine.combine_fused(a, b, e, eps[:, :, i * (k // 2):(i + 1) * (k // 2)]
                                          .contiguous(), s, log_norm=nrm)
                    for i, e in enumerate(es)]
            st = [o[4] for o in outs]
            return (torch.cat([o[0] for o in outs], dim=2), torch.cat([o[1] for o in outs], 1),
                    torch.cat([o[2] for o in outs], 1), outs[0][3] + outs[1][3],
                    gmm.GmmSuffStats(*(torch.cat(t) for t in zip(*st))))

        a_out = outputs(sharded(pot_h, pot_p, *exp))
        for name, tol in value_tol.items():
            close(f"2 shards vs unsharded {label} {name}", a_out[name], b_out[name], tol, tol)
        e_sh = held(f"2 shards vs unsharded {label}", grads(sharded, (pot_h, pot_p, *exp), scalar),
                    grads(chain(False), (pot_h, pot_p, *exp), scalar), 5e-4)
        lines.append(f"{label} N={n} K={k} (2 shards of {k // 2}) d={d} S={s}: identity "
                     f"gradients {e_id:.3e}, 2 shards vs unsharded gradients {e_sh:.3e}")
    # Every d at one bigk K-shard: log ρ within 2e-5 of the plain version and
    # equal to the log_norm combine's log r̃ at a zero normaliser.
    for d in combine.LATENT_DIMS:
        pot_h, pot_p, exp, eps = combine_inputs(dev, 1024, 50, d, 1, seed=d)
        got = combine.log_rho_fused(pot_h, pot_p, exp)
        errs["log_rho_fwd"] = max(errs["log_rho_fwd"], close(
            f"log rho K=50 d={d}", got, combine.log_rho_plain(pot_h, pot_p, exp), 2e-5, 2e-5))
        lr0 = combine.combine_fused(pot_h, pot_p, exp, eps, 1,
                                    log_norm=torch.zeros(1024, device=dev))[1]
        assert torch.equal(got, lr0), f"log rho K=50 d={d} differs from the combine's"
    lines.append("log rho equal to the log_norm combine's log r̃ at a zero normaliser bit for "
                 f"bit at every d ({', '.join(map(str, combine.LATENT_DIMS))}) at N=1024 K=50 "
                 "and at each shape and shard above")
    print("phase H: rho-kernel and log_norm combine vs plain (values 2e-5, local and stats "
          "2e-4, gradients 5e-4 of each largest entry, every cotangent path, reruns "
          "bit-equal): max abs err " + ", ".join(f"{k_} {v:.3e}" for k_, v in errs.items())
          + "; " + "; ".join(lines), flush=True)

    n, k, d, s = 1024, 50, 10, 1  # one bigk K-shard of two
    t = timed_fresh("time_comp", n, k, d, s)
    for part in ("fwd", "bwd_a"):
        if t[f"kernel_rho_{part}_launches"] != 1:
            raise AssertionError(f"log_rho_{part}: {t[f'kernel_rho_{part}_launches']:g} kernels "
                                 "a call, not one launch")
    fb, bb = (combine_bound(n, k, d, s, b_, norm=True) for b_ in (False, True))
    ab = combine_bound(n, k, d, s, True, norm=True, main_path=True)
    rb = {"fwd": rho_bound(n, k, d, False), "bwd_a": rho_bound(n, k, d, True, main_path=True),
          "bwd_b": rho_bound(n, k, d, True)}
    print(f"phase H: device ms per call at the bigk shard N={n} K={k} d={d} S={s}: "
          + ", ".join(f"log_rho_{part} {t[f'kernel_rho_{part}_device']:.4f} (plain "
                      f"{t[f'plain_rho_{part}_device']:.4f}, CUDA events "
                      f"{t[f'kernel_rho_{part}_call']:.4f}; bound {rb[part][0] * 1e3:.3f} us, "
                      f"{rb[part][1]})" for part in ("fwd", "bwd_a", "bwd_b"))
          + f" — bwd_a the train step's call ({t['kernel_rho_bwd_a_launches']:g} kernel a call),"
          f" bwd_b with dw (kernel {t['kernel_rho_bwd_b_kernel']:.4f} + reduce "
          f"{t['kernel_rho_bwd_b_reduce']:.4f}, {t['kernel_rho_bwd_b_launches']:g} kernels)"
          + "; the log_norm combine's " + combine_times_line(t, "norm_", fb, ab, bb)
          + f"; {card}", flush=True)
    base = {"route": "cuda", "library_ms": None}
    return [
        {"name": "log_rho_fwd", "source": "svax_torch/ops/csrc/combine.cu",
         "replaces": "svax/ops/combine_pallas.py:288", "max_abs_err": errs["log_rho_fwd"],
         "ms": t["kernel_rho_fwd_device"], "plain_ms": t["plain_rho_fwd_device"],
         "bound_ms": rb["fwd"][0], "bound_by": rb["fwd"][1], **base},
        {"name": "log_rho_bwd", "source": "svax_torch/ops/csrc/combine.cu",
         "replaces": "svax/ops/combine_pallas.py:342", "max_abs_err": errs["log_rho_bwd"],
         "ms": t["kernel_rho_bwd_a_device"], "plain_ms": t["plain_rho_bwd_a_device"],
         "bound_ms": rb["bwd_a"][0], "bound_by": rb["bwd_a"][1], **base,
         "full_ms": t["kernel_rho_bwd_b_device"], "full_plain_ms": t["plain_rho_bwd_b_device"],
         "full_bound_ms": rb["bwd_b"][0]},
        {"name": "combine_fwd_norm", "source": "svax_torch/ops/csrc/combine.cu",
         "replaces": "svax/ops/combine_pallas.py:431", "max_abs_err": errs["combine_fwd_norm"],
         "ms": t["kernel_norm_fwd_device"], "plain_ms": t["plain_norm_fwd_device"],
         "bound_ms": fb[0], "bound_by": fb[1], **base},
        {"name": "combine_bwd_norm", "source": "svax_torch/ops/csrc/combine_bwd.cu",
         "replaces": "svax/ops/combine_pallas.py:588", "max_abs_err": errs["combine_bwd_norm"],
         "ms": t["kernel_norm_bwd_a_device"], "plain_ms": t["plain_norm_bwd_a_device"],
         "bound_ms": ab[0], "bound_by": ab[1], **base,
         "full_ms": t["kernel_norm_bwd_b_device"], "full_plain_ms": t["plain_norm_bwd_b_device"],
         "full_bound_ms": bb[0], "full_source": "svax_torch/ops/csrc/combine_bwd_full.cu"},
    ]


def covered_us(ranges) -> float:
    """µs covered by the union of profiler time ranges (nested or repeated
    spans of one collective count once)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((r.start, r.end) for r in ranges):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _bigk_rank(rank: int, world: int, dev, state, steps: int) -> dict:
    """Phase I (b) and (c) on one of two ranks sharing the card: bigk-dp at
    full width from ``state``, on a 1x2 comp mesh twice, then on a 2x1 data
    mesh; rank 0 also takes the single-process step 1 and the test ELBO."""
    import torch

    from svax_torch import convert
    from svax_torch.configs import CONFIGS
    from svax_torch.data import load_dataset
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.measure_mixture import device_us, profiled
    from svax_torch.ops import combine
    from svax_torch.parallel import mesh
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = CONFIGS["bigk-dp"]
    train, test, meta = load_dataset("mnist", seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    x_test = torch.tensor(test, dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=cfg["latent_dim"], num_components=cfg["num_components"],
                        num_samples=cfg["num_samples"], num_total=x.shape[0],
                        likelihood="bernoulli", nn_compute_dtype=cfg["nn_compute_dtype"],
                        fused_combine=True, kernel_rng=True, fused_mlp_decoder=True)
    prior = gmm.make_prior(config.num_components, config.latent_dim, alpha=cfg["alpha"],
                           kappa=cfg["kappa"], device=dev)
    state0 = svae_step.state_to(state, dev)
    meshes = {"comp": mesh.make_data_comp_mesh(1, 2), "data": mesh.make_data_comp_mesh(2, 1)}
    kw = dict(lr=cfg["lr"], rho=cfg["rho"], rho_decay=cfg["rho_decay"],
              batch_size=cfg["batch_size"], replace=False)
    evaluate = svae_step.make_eval_fn(config, prior)

    def test_elbo(st):
        return float(evaluate(st, x_test, seed=1)["elbo_per_point"])

    out = {}
    for name, runs in (("comp", 2), ("data", 1)):
        m = meshes[name]
        prior_l = convert.shard_nat(prior, m.comp_idx, m.comp)
        for run in range(runs):
            st = state0._replace(pgm_nat=convert.shard_nat(state0.pgm_nat, m.comp_idx, m.comp))
            runner = loop.make_step_runner(config, prior_l, data_group=m.data_group,
                                           comp_group=m.comp_group, **kw)
            combine.rho_launches = combine.rho_backward_launches = 0
            combine.norm_launches = combine.norm_backward_launches = 0
            combine.norm_lean_backward_launches = 0
            combine.rho_backward_paths.clear()
            st, m1 = runner(st, x, 1, seed=0)
            nat1 = svae_step.nat_to(convert.gather_nat(st.pgm_nat, m.comp_group), "cpu")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, mets = runner(st, x, steps - 1, seed=0)
            torch.cuda.synchronize()
            rate = (steps - 1) / (time.perf_counter() - t0)
            # The train step's log_norm backward is combine_bwd_lean's call.
            assert combine.norm_backward_launches == combine.norm_lean_backward_launches
            launches = [combine.rho_launches, combine.rho_backward_launches,
                        combine.norm_launches, combine.norm_lean_backward_launches]
            nat = convert.gather_nat(st.pgm_nat, m.comp_group)
            row = {"nat1": nat1, "launches": launches, "steps_per_s": rate,
                   "rho_paths": dict(combine.rho_backward_paths),
                   "elbo": [float(m1["elbo"][0]), float(mets["elbo"][-1])],
                   "leaves": [t.cpu() for t in leaves(st)]}
            if run == 0:
                if rank == 0:
                    row["test_elbo"] = test_elbo(st._replace(pgm_nat=nat))
                # 10 more steps under the profiler: this rank's kernel time
                # and its collectives (gloo's host-side spans).
                wall, prof = profiled(lambda: runner(st, x, 10, seed=1))
                events = list(prof.events())
                row["profile"] = {
                    "wall_ms": wall / 10, "device_ms": device_us(prof) / 1e4,
                    "collectives": sum(e.name == "c10d::allreduce_" for e in events) / 10,
                    "collective_ms": covered_us(e.time_range for e in events
                                                if e.name == "gloo:all_reduce") / 1e4}
            out[f"{name}{run}"] = row
    if rank == 0:
        single = loop.make_step_runner(config, prior, **kw)
        out["single_nat1"] = svae_step.nat_to(single(state0, x, 1, seed=0)[0].pgm_nat, "cpu")
        out["test_elbo0"] = test_elbo(state0)
    return out


def _gmm_dp_rank(rank: int, world: int, dev, argv: list) -> dict:
    """Phase I (d) on one of two ranks sharing the card: ``train_gmm --dp``
    in the group ``mesh.spawn`` joined (gloo on cuda:0)."""
    import os

    from svax_torch import train_gmm
    from svax_torch.ops import estep

    # train_gmm reads the world size from torchrun's variable and finds the
    # group joined; LOCAL_RANK 0 keeps its "cuda" on the one card.
    os.environ.update(WORLD_SIZE=str(world), LOCAL_RANK="0")
    estep.launches = 0
    out = train_gmm.main(argv)
    return {"nat": [t.cpu() for t in nat_leaves(out["state"].nat)], "rows": out["rows"],
            "launches": estep.launches, "steps_per_s": out["steps_per_s"],
            "predictive": out.get("test_predictive_loglik_per_point")}


def parallel_phase(card: str) -> list:
    """Phase I; returns the four kernels' launches on the comp-sharded bigk
    main path (both ranks, the first run)."""
    import torch

    from svax_torch import train_svae
    from svax_torch.parallel import mesh
    from svax_torch.parallel.dryrun import dryrun_multichip
    from svax_torch.train import svae_step

    # (a) the dry run's three geometries on a 2x2 mesh, four ranks on cuda:0.
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, "cuda:0", "gloo", timeout=300.0)
    assert all(math.isfinite(r[g]["elbo"]) for r in dry["ranks"] for g in ("toy", "bigk", "smm"))
    print(f"phase I: dryrun_multichip(4) on cuda:0 over gloo (2x2 data x comp; gloo carries "
          f"the CUDA tensors, mesh.psum stages nothing): sharded naturals vs the "
          f"single-process step, max rel err "
          + ", ".join(f"{g} {dry[g]['nat_err']:.3e}" for g in ("toy", "bigk", "smm"))
          + f" (bar 1e-5); bigk rho-kernel / log_norm combine launches per rank "
          f"{[r['bigk']['launches'] for r in dry['ranks']]}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)

    # (b), (c): bigk-dp at full width from a warmed-up state, two ranks on cuda:0.
    steps = 100
    warm = train_svae.main(["--config", "bigk-dp", "--warmup-steps", "300", "--steps", "1",
                            "--device", "cuda", "--seed", "0", "--iw-samples", "0"])
    state = svae_step.state_to(warm["state"], "cpu")
    t0 = time.perf_counter()
    ranks = mesh.spawn(_bigk_rank, 2, "cuda:0", "gloo", args=(state, steps), timeout=600.0)
    r0 = ranks[0]

    def nat_err(got, want) -> float:
        return max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(nat_leaves(got), nat_leaves(want)))

    for name in ("comp0", "data0"):
        err = nat_err(r0[name]["nat1"], r0["single_nat1"])
        assert err < 1e-5, f"{name}: step 1's naturals differ from one process by {err:.3e}"
        r0[name]["nat1_err"] = err
        assert all(math.isfinite(v) for r in ranks for v in r[name]["elbo"])
    for r in ranks:
        assert all(torch.equal(a, b) for a, b in zip(r["comp0"]["leaves"],
                                                      r["comp1"]["leaves"])), \
            "two comp-sharded bigk-dp runs differ"
        assert r["comp0"]["launches"] == [steps] * 4, r["comp0"]["launches"]
        # The train step owes the ρ-kernel no dw: configuration (a) only.
        assert r["comp0"]["rho_paths"] == {"dpot": steps}, r["comp0"]["rho_paths"]
        assert r["data0"]["launches"] == [0] * 4, r["data0"]["launches"]
    start, end = r0["test_elbo0"], r0["comp0"]["test_elbo"]
    assert end > start, f"comp-sharded bigk-dp: test ELBO/pt {start} -> {end}"
    print(f"phase I: bigk-dp at full width, {steps} steps from a 300-step warmup, two ranks "
          f"on cuda:0 over gloo: 1x2 comp mesh {r0['comp0']['steps_per_s']:.1f} steps/s "
          f"(runs bit-equal; per rank log_rho fwd/bwd, norm combine fwd/bwd launches "
          f"{[r['comp0']['launches'] for r in ranks]}; rho_backward_paths per rank "
          f"{[r['comp0']['rho_paths'] for r in ranks]}; step 1 naturals vs one process "
          f"{r0['comp0']['nat1_err']:.3e}; test ELBO/pt {start:.4f} -> {end:.4f}); 2x1 data "
          f"mesh {r0['data0']['steps_per_s']:.1f} steps/s (step 1 naturals vs one process "
          f"{r0['data0']['nat1_err']:.3e}; training ELBO {r0['data0']['elbo'][0]:.1f} -> "
          f"{r0['data0']['elbo'][1]:.1f}); {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    # (d) train_gmm --dp on the plain engine with the estep kernel, two ranks
    # on cuda:0, against the one-process run of the same command.
    from svax_torch import train_gmm

    argv = ["--config", "pinwheel-gmm", "--init", "kmeanspp", "--device", "cuda",
            "--engine", "plain", "--fused-kernel", "--dp"]
    t0 = time.perf_counter()
    gmm_ranks = mesh.spawn(_gmm_dp_rank, 2, "cuda:0", "gloo", args=(argv,), timeout=300.0)
    one = train_gmm.main(argv)
    g0 = gmm_ranks[0]
    assert [r["launches"] for r in gmm_ranks] == [300, 300], [r["launches"] for r in gmm_ranks]
    assert g0["rows"] and not gmm_ranks[1]["rows"], "rank 1 printed rows"
    gmm_nat_err = max(rel_err(a, b.cpu())
                      for a, b in zip(g0["nat"], nat_leaves(one["state"].nat)))
    assert gmm_nat_err < 1e-4, f"train_gmm --dp: final naturals rel err {gmm_nat_err:.3e}"
    gmm_elbo_err = max(abs(a["elbo"] - b["elbo"]) / abs(b["elbo"])
                       for a, b in zip(g0["rows"], one["rows"]))
    assert len(g0["rows"]) == len(one["rows"]) and gmm_elbo_err < 1e-4, gmm_elbo_err
    assert math.isclose(g0["predictive"], one["test_predictive_loglik_per_point"],
                        rel_tol=1e-4), (g0["predictive"], one)
    print(f"phase I: train_gmm --dp --engine plain --fused-kernel (pinwheel-gmm, 300 steps), "
          f"two ranks on cuda:0 over gloo: estep launches per rank "
          f"{[r['launches'] for r in gmm_ranks]}; rows from rank 0 only; vs the one-process "
          f"run: final naturals max rel err {gmm_nat_err:.3e} (bar 1e-4), ELBO rows "
          f"{gmm_elbo_err:.3e} (bar 1e-4), predictive {g0['predictive']:.5f} vs "
          f"{one['test_predictive_loglik_per_point']:.5f}; {g0['steps_per_s']:.1f} steps/s "
          f"(one process {one['steps_per_s']:.1f}); {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    for name in ("comp0", "data0"):
        prof = [r[name]["profile"] for r in ranks]
        print(f"phase I: {name[:-1]} mesh, 10 steps under torch.profiler on each rank: wall "
              f"{prof[0]['wall_ms']:.2f} ms a step; the rank's kernel spans a step "
              + " / ".join(f"{p['device_ms']:.2f}" for p in prof)
              + " ms (the two ranks' contexts take turns on the card, so a span may hold "
              "the other's turn); all-reduces a step per rank "
              + " / ".join(f"{p['collectives']:.0f}, the host inside gloo for "
                           f"{p['collective_ms']:.2f} ms" for p in prof) + f"; {card}",
              flush=True)
    return [sum(r["comp0"]["launches"][i] for r in ranks) for i in range(4)]


def rowsum_phase(card: str) -> list:
    """Phase J; returns the rowsum_fwd and rowsum_bwd entries of the kernels
    line at the bigk shape, in the f32 mode and then the bf16-operand mode
    (each path's, without launches)."""
    import torch

    from svax_torch.measure_mnist import (ROWSUM_F64_TOL, ROWSUM_TOL, rowsum_bound,
                                          rowsum_errors, rowsum_f64_errors, rowsum_failures,
                                          rowsum_grads, rowsum_inputs, rowsum_s_f64_error,
                                          sm_clock_hz, time_rowsum)
    from svax_torch.ops import decoder

    dev = torch.device("cuda", 0)
    clock = sm_clock_hz()
    entries = []
    for label, m in (("bigk", 102400), ("mnist", 2560)):
        for precision in ("highest", "default"):
            args = rowsum_inputs(dev, m, 200, 784)
            e = rowsum_errors(*args, precision)
            bad = rowsum_failures(e, precision)
            assert not bad, f"rowsum {label} {precision}: {bad} ({e})"
            twice = [rowsum_grads(decoder.rowsum_logsig_neg, *args, precision)
                     for _ in range(2)]
            assert torch.equal(twice[0][0], twice[1][0]), f"rowsum {label}: forward reruns differ"
            assert all(torch.equal(a, b) for a, b in zip(twice[0][1], twice[1][1])), \
                f"rowsum {label} {precision}: backward reruns differ"
            f64 = ""
            if precision == "highest":
                e64 = rowsum_f64_errors(twice[0][1], *args)
                assert max(e64.values()) <= ROWSUM_F64_TOL, f"rowsum {label} against f64: {e64}"
                s64 = {"s": rowsum_s_f64_error(twice[0][0], *args[:3]),
                       "plain s": rowsum_s_f64_error(
                           decoder.rowsum_logsig_neg_plain(*args[:3], precision), *args[:3])}
                assert s64["s"] <= max(2.0 * s64["plain s"], 2.0 ** -24), \
                    f"rowsum {label}: s against f64 {s64}"
                e64.update(s64)
                f64 = (" against f64: " + ", ".join(f"{k_} {v:.3e}" for k_, v in e64.items())
                       + f" (bar {ROWSUM_F64_TOL}; s within twice the plain version's);")
            t = time_rowsum(dev, m, 200, 784, precision)
            bf16 = precision != "highest"
            fb, bb = (rowsum_bound(m, 200, 784, backward=b_, bf16=bf16, sm_clock_hz=clock)
                      for b_ in (False, True))
            print(f"phase J: rowsum vs plain at {label} M,Dh,D=({m}, 200, 784) {precision}: "
                  + ", ".join(f"{k_} {v:.3e}" for k_, v in e.items() if k_ != "finite")
                  + f" (bars {ROWSUM_TOL});{f64} reruns bit-equal; CUDA-event ms per call: "
                  f"forward {t['kernel_fwd']:.4f} (plain {t['plain_fwd']:.4f}, unfused f32 "
                  f"{t['unfused_fwd']:.4f}: "
                  f"{'no slower' if t['kernel_fwd'] <= t['unfused_fwd'] else 'slower'}), "
                  f"backward {t['kernel_bwd']:.4f} (plain "
                  f"{t['plain_bwd']:.4f}, unfused f32 {t['unfused_bwd']:.4f}: "
                  f"{'no slower' if t['kernel_bwd'] <= t['unfused_bwd'] else 'slower'}); bound "
                  f"forward {fb['ms'] * 1e3:.2f} us ({fb['by']}: products "
                  f"{fb['products_ms'] * 1e3:.2f} as {fb['products_by']}, special functions "
                  f"{fb['special_ms'] * 1e3:.2f} at {clock / 1e6:.0f} MHz, bytes "
                  f"{fb['bytes_ms'] * 1e3:.2f}; the forward at "
                  f"{fb['ms'] / t['kernel_fwd']:.1%} of it), backward {bb['ms'] * 1e3:.2f} us ({bb['by']}: "
                  f"products {bb['products_ms'] * 1e3:.2f} as {bb['products_by']}, special functions "
                  f"{bb['special_ms'] * 1e3:.2f}, bytes {bb['bytes_ms'] * 1e3:.2f}); {card}",
                  flush=True)
            if label == "bigk":
                common = {"route": "cuda", "source": "svax_torch/ops/csrc/decoder.cu",
                          "library_ms": None}
                suffix = "" if precision == "highest" else "_bf16"
                entries += [
                    {"name": f"rowsum_fwd{suffix}", **common,
                     "replaces": "svax/ops/decoder_pallas.py:64", "max_abs_err": e["s max abs"],
                     "ms": t["kernel_fwd"], "plain_ms": t["plain_fwd"], "bound_ms": fb["ms"],
                     "bound_by": fb["by"], "unfused_f32_ms": t["unfused_fwd"]},
                    {"name": f"rowsum_bwd{suffix}", **common,
                     "replaces": "svax/ops/decoder_pallas.py:114",
                     "max_abs_err": e["grad max abs"], "ms": t["kernel_bwd"],
                     "plain_ms": t["plain_bwd"], "bound_ms": bb["ms"], "bound_by": bb["by"],
                     "unfused_f32_ms": t["unfused_bwd"]},
                ]
    forward_ptxas("rowsum_fwd", "J")
    return entries


# Phase K (a)'s bars for the row sum fused against unfused over 3 steps:
# at "highest" both are f32 (elbo relative, parameters where they moved,
# Adam moments of each leaf's largest, naturals rtol/atol); at "high" the
# fused row sum runs the bf16-operand mode against the unfused f32 one, so
# the gap is a bf16 rounding's, measured on the card (PERF.md, PR 17).
ROWSUM_STEP_BARS = {"highest": {"elbo": 1e-5, "params where moved": 5e-5, "adam": 1e-3,
                                "naturals": 1e-4},
                    "high": {"elbo": 1e-4, "params where moved": 1e-2, "adam": 3e-2,
                             "naturals": 1e-2}}


def fused_decoder_phase(card: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """Phase K; returns the row-sum forward and backward launches of the big-K
    f32 fused_decoder path in the f32 mode (``--nn-precision highest``) and
    in the bf16-operand mode (the default "high", the main path's)."""
    import numpy as np
    import torch

    from svax_torch import train_svae
    from svax_torch.measure_mnist import bigk_f32_rates, bigk_f32_setup, quality
    from svax_torch.ops import decoder, decoder_mlp

    dev = torch.device("cuda", 0)
    # (a) 3 steps from one seeded state with injected numpy ε, the row sum in
    # the kernels against the unfused f32 row sum, at both precisions.
    eps = torch.tensor(np.random.default_rng(5).standard_normal((3, 1, 1024, 100, 10)),
                       dtype=torch.float32, device=dev)
    for precision, bars in ROWSUM_STEP_BARS.items():
        runs = {}
        for fused in (True, False):
            runner, state, x = bigk_f32_setup(dev, fused, nn_precision=precision)
            runs[fused] = runner(state, x, 3, seed=0, eps=eps)
        (st_f, met_f), (st_u, met_u) = runs[True], runs[False]
        errs = {"elbo": max(abs(float(a) - float(b)) / abs(float(b))
                            for a, b in zip(met_f["elbo"], met_u["elbo"]))}
        moved = []
        for got, want, m_ in zip(flat(st_f.nn_params), flat(st_u.nn_params),
                                 flat(st_u.opt_state.mu)):
            keep = m_.abs() >= 0.05 * m_.abs().max()
            moved.append(float((got - want).abs()[keep].max()))
        errs["params where moved"] = max(moved)
        for name, tk, tu in (("adam m", st_f.opt_state.mu, st_u.opt_state.mu),
                             ("adam v", st_f.opt_state.nu, st_u.opt_state.nu)):
            errs[name] = max(float((a - b).abs().max()) / float(b.abs().max())
                             for a, b in zip(flat(tk), flat(tu)))
        if precision == "highest":
            errs["naturals"] = max(close(f"{precision} naturals", a, b, bars["naturals"],
                                         bars["naturals"])
                                   for a, b in zip(nat_leaves(st_f.pgm_nat),
                                                   nat_leaves(st_u.pgm_nat)))
        else:  # of each leaf's largest, as the Adam moments
            errs["naturals"] = max(rel_err(a, b) for a, b in zip(nat_leaves(st_f.pgm_nat),
                                                                 nat_leaves(st_u.pgm_nat)))
            assert errs["naturals"] < bars["naturals"], errs
        how = "rtol/atol" if precision == "highest" else "of each leaf's largest"
        print(f"phase K: big-K f32 step at nn_precision {precision} (row sum in its "
              f"{'f32' if precision == 'highest' else 'bf16-operand'} mode), 3 steps with "
              "injected noise, fused vs unfused: "
              + ", ".join(f"{k_} {v:.3e}" for k_, v in errs.items())
              + f" (bars: elbo {bars['elbo']} relative; params {bars['params where moved']} "
              "where the first moment is at least 5% of its leaf's largest; Adam moments "
              f"{bars['adam']} of each leaf's largest; naturals {bars['naturals']} {how})",
              flush=True)
        assert errs["elbo"] < bars["elbo"], errs
        assert errs["params where moved"] < bars["params where moved"], errs
        assert max(errs["adam m"], errs["adam v"]) < bars["adam"], errs
    # (b) the main path: bigk-dp's recipe with the f32 decoder and the row sum
    # in the kernels, from the entry, at the default nn_precision "high":
    # the row sum's bf16-operand mode.
    argv = ["--config", "bigk-dp", "--nn-compute-dtype", "float32", "--no-fused-mlp-decoder",
            "--fused-decoder", "--warmup-steps", "300", "--steps", "600", "--device", "cuda",
            "--seed", "0", "--iw-samples", "0"]
    decoder.launches = decoder.backward_launches = 0
    decoder.bf16_launches = decoder.bf16_backward_launches = 0
    decoder_mlp.launches = decoder_mlp.backward_launches = 0
    run = train_svae.main(argv)
    launches = (decoder.launches, decoder.backward_launches)
    rows = run["rows"]
    assert [r["step"] for r in rows] == [1, 200, 400, 600], [r["step"] for r in rows]
    # One forward and one backward a step (300 warmup + 600), and one forward
    # for each test ELBO (before training and at every row), all in the
    # bf16-operand mode.
    assert launches == (900 + len(rows) + 1, 900), f"row-sum launches {launches}"
    assert (decoder.bf16_launches, decoder.bf16_backward_launches) == launches
    assert (decoder_mlp.launches, decoder_mlp.backward_launches) == (0, 0)
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run["state"]))
    start, end = run["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    purity, used = quality(run, 0)
    print(f"phase K: big-K f32 fused_decoder main path (bigk-dp, --nn-compute-dtype float32 "
          f"--no-fused-mlp-decoder --fused-decoder at the default nn_precision high: the "
          f"row sum's bf16-operand mode; 300 warmup + 600 joint steps, seed 0): "
          f"row sum {launches[0]} forward / {launches[1]} backward launches, all bf16-operand, "
          f"warmup {run['warmup']['seconds']:.1f} s, {run['steps_per_s']:.1f} steps/s, test "
          f"ELBO/pt {start:.4f} -> {end:.4f}, purity {purity:.4f}, {used} of 100 components "
          f"in use; {card}", flush=True)
    assert end > start + 100.0, f"big-K f32: test ELBO/pt {start} -> {end}"
    assert purity > 0.7, f"big-K f32: cluster purity {purity}"
    assert used >= 6, f"big-K f32: only {used} of 100 components in use"
    # (b') the row sum's f32 mode on the same path under --nn-precision
    # highest, cut to 100 + 100 steps: its launches.
    decoder.launches = decoder.backward_launches = 0
    decoder.bf16_launches = decoder.bf16_backward_launches = 0
    f32_run = train_svae.main([*argv[:6], "--warmup-steps", "100", "--steps", "100",
                               "--device", "cuda", "--seed", "0", "--iw-samples", "0",
                               "--nn-precision", "highest"])
    f32_launches = (decoder.launches, decoder.backward_launches)
    assert f32_launches[1] == 200 and decoder.bf16_launches == 0, f32_launches
    assert all(math.isfinite(v) for r in f32_run["rows"] for v in r.values())
    print(f"phase K: the same path at --nn-precision highest (the row sum's f32 mode), 100 "
          f"warmup + 100 steps: {f32_launches[0]} forward / {f32_launches[1]} backward "
          f"launches, {f32_run['steps_per_s']:.1f} steps/s; {card}", flush=True)
    # (c) the step's rate with the row sum fused and unfused, in turns.
    rates = bigk_f32_rates(dev)
    print("phase K: big-K f32 step at nn_precision high (make_step_runner, 100 steps a turn; "
          "turns unfused, fused, fused, unfused): " + "; ".join(
              f"row sum {name} " + " / ".join(f"{v:.1f}" for v in r["rates"])
              + f" steps/s, 20 profiled steps: wall {r['wall_ms']:.3f} ms, device "
              f"{r['device_ms']:.3f} ms a step, idle share {100 * r['idle']:.1f}%, row-sum "
              f"kernels {r['rowsum_ms']:.3f} ms a step" for name, r in rates.items())
          + f"; {card}", flush=True)
    return f32_launches, launches


# Phase L's child: serves the exported artifacts in a process whose import
# of the model modules raises; prints the latencies and saves the answers.
_EXPORTED_CHILD = """
import importlib.abc, json, sys, time

BLOCKED = ("svax_torch.models", "svax_torch.nets", "svax_torch.pgm", "svax_torch.train",
           "svax_torch.ops", "svax_torch.expfam")
# The graph engine (torch alone) replays the programs on the card.
ALLOWED = ("svax_torch.train", "svax_torch.train.graph")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if (name.startswith(BLOCKED) and name not in ALLOWED) or name == "jax" or \\
                name.startswith("jax."):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
from svax_torch import serve

servers = {"graphed": serve.load_exported(sys.argv[1]),
           "eager": serve.load_exported(sys.argv[1], graph=False)}
data = np.load(sys.argv[2])
out, lat, equal = {}, {"graphed": {}, "eager": {}}, {}


def answers(got):
    return got.items() if isinstance(got, dict) else [("", got)]


for b in (*servers["graphed"]._buckets, 2 * servers["graphed"]._buckets[-1]):
    x, mask = data[f"x{b}"], data[f"mask{b}"]
    calls = {route: {"encode": lambda s=s: s.encode(x),
                     "reconstruct": lambda s=s: s.reconstruct(x),
                     "impute": lambda s=s: s.impute(x, mask),
                     "score": lambda s=s: s.score(x, seed=3)}
             for route, s in servers.items()}
    for name in calls["graphed"]:
        got = {route: c[name]() for route, c in calls.items()}
        equal[f"{name}_{b}"] = all(np.array_equal(v, dict(answers(got["eager"]))[k])
                                   for k, v in answers(got["graphed"]))
        if b in servers["graphed"]._buckets:
            for route in ("eager", "graphed", "graphed", "eager"):
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    calls[route][name]()
                    times.append(time.perf_counter() - t0)
                lat[route].setdefault(f"{name}_{b}", []).append(sorted(times)[2] * 1e3)
            for key, value in answers(got["graphed"]):
                out[f"{name}_{b}_{key}"] = value
np.savez(sys.argv[3], **out)
try:
    import svax_torch.models
    blocked = False
except ImportError:
    blocked = True
print("RESULT " + json.dumps({"latency_ms": lat, "equal": equal, "models_blocked": blocked,
                              "device": str(servers["graphed"].device),
                              "routes": {r: s.route for r, s in servers.items()},
                              "captures": servers["graphed"].graphs.captures}))
"""


def _same_state(path_a: Path, path_b: Path) -> bool:
    import torch

    a = torch.load(path_a, weights_only=True)["state"]
    b = torch.load(path_b, weights_only=True)["state"]
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _near_ties(resp, margin: float):
    """Rows whose two largest responsibilities lie within ``margin``."""
    import numpy as np

    top = -np.sort(-np.asarray(resp), axis=-1)
    return (top[:, 0] - top[:, 1]) < margin


def harness_phase(card: str, served: dict, work: Path) -> None:
    """Phase L: the training harness (checkpoint/resume through every kernel
    engine, JSONL rows, best tracking) and the serving layer (phase D's
    mnist-svae bundle live on the card, against the CPU, and its exported
    tier in a child process without the model modules)."""
    import numpy as np
    import torch

    from svax_torch import serve, train_svae
    from svax_torch.data import load_dataset, load_mnist
    from svax_torch.measure_graphs import median_ms
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.models import evaluation
    from svax_torch.models.gmm_baseline import GmmTrainState
    from svax_torch.models.svae import SvaeConfig, sin_combine
    from svax_torch.nets import mlp as nets
    from svax_torch.ops import combine, decoder_mlp, estep, flexstep, mixstep, tinystep
    from svax_torch.pgm import gmm
    from svax_torch.pgm.init import init_variational_kmeanspp
    from svax_torch.train.checkpoint import Checkpointer
    from svax_torch.train.metrics import read_jsonl
    from svax_torch.train.trainer import GmmTrainer, SvaeTrainer, TrainerConfig
    from svax_torch.utils.tree import flatten

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()

    def same(a, b) -> bool:
        return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for (_, x), (_, y) in zip(flatten(a), flatten(b)))

    # 1. the entry's resume through tinystep (pinwheel-svae, full width)
    argv = ["--config", "pinwheel-svae", "--device", "cuda", "--seed", "0", "--iw-samples",
            "0"]
    tinystep.launches = tinystep.launches_bf16 = 0
    a = train_svae.main(argv + ["--steps", "2000", "--checkpoint-dir", str(work / "A")])
    b1 = train_svae.main(argv + ["--steps", "1000", "--checkpoint-dir", str(work / "B")])
    b2 = train_svae.main(argv + ["--steps", "2000", "--checkpoint-dir", str(work / "B"),
                                 "--resume", "--logfile", str(work / "B.jsonl")])
    launches = tinystep.launches_bf16  # the config's nn_precision "default"
    assert tinystep.launches == 0, tinystep.launches
    assert a["kernel"] == "tinystep" and launches == 4, (a["kernel"], launches)
    assert _same_state(work / "A" / "step_2000.pt", work / "B" / "step_2000.pt"), \
        "pinwheel-svae: the resumed run's final checkpoint differs from the whole run's"
    assert same(a["state"], b2["state"]) and read_jsonl(work / "B.jsonl") == b2["rows"]
    assert b2["rows"][-1]["test_elbo_per_point"] == a["rows"][-1]["test_elbo_per_point"]
    print(f"phase L: train_svae pinwheel-svae 2000 steps vs 1000 + --resume 1000 (tinystep, "
          f"{launches} launches): final checkpoints bit-equal; ms a step: whole "
          f"{1e3 / a['steps_per_s']:.4f}, first leg {1e3 / b1['steps_per_s']:.4f}, resumed "
          f"leg {1e3 / b2['steps_per_s']:.4f} (chunks of 1000, each row's evaluation "
          f"included); {card}", flush=True)

    # 2. SvaeTrainer's resume through flexstep (auto-svae, full width)
    train, test, _ = load_dataset("auto", seed=0)
    mc = SvaeConfig(latent_dim=4, num_components=10, num_samples=4, num_total=len(train))

    def auto_fit(steps, ck):
        tc = TrainerConfig(steps=steps, batch_size=64, lr=1e-3, rho=0.2, rho_decay=0.001,
                           eval_every=500, scan_chunk=500, encoder_hidden=(100, 100),
                           decoder_hidden=(100, 100), engine="kernel",
                           checkpoint_dir=str(work / ck))
        trainer = SvaeTrainer(mc, tc, input_dim=train.shape[1])
        t0 = time.perf_counter()
        state = trainer.fit(train.astype(np.float32), test.astype(np.float32))
        return trainer, state, (time.perf_counter() - t0) * 1e3 / (steps - trainer._start)

    flexstep.launches = 0
    whole, s_whole, ms_whole = auto_fit(1000, "C")
    _, _, ms_first = auto_fit(500, "D")
    resumed, s_res, ms_res = auto_fit(1000, "D")
    assert whole.kernel == resumed.kernel == "flexstep" and flexstep.launches == 4
    assert same(s_whole, s_res), "auto-svae: SvaeTrainer's resumed fit differs"
    assert set(whole.best) == {"metric", "best_value", "best_step", "best_wall_s", "target",
                               "target_step", "target_wall_s", "stopped_early", "steps_run",
                               "total_wall_s"}
    assert len(Checkpointer(work / "C" / "best").all_steps()) == 1
    print(f"phase L: SvaeTrainer auto-svae 1000 steps vs 500 + resume (flexstep, "
          f"{flexstep.launches} launches): bit-equal, best {whole.best['metric']} "
          f"{whole.best['best_value']:.4f} at step {whole.best['best_step']}; ms a step "
          f"(fit wall over its steps, evaluations included): whole {ms_whole:.4f}, first leg "
          f"{ms_first:.4f}, resumed leg {ms_res:.4f}; {card}", flush=True)

    # 3. the per-step engine at mnist-svae's width: combine and decoder kernels
    train, test, meta = load_dataset("mnist", seed=0)
    mc = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=len(train),
                    likelihood="bernoulli", nn_compute_dtype="bfloat16", fused_combine=True,
                    kernel_rng=True, fused_mlp_decoder=True)

    def mnist_fit(steps, ck):
        tc = TrainerConfig(steps=steps, batch_size=256, lr=1e-3, rho=0.1, rho_decay=0.001,
                           eval_every=100, scan_chunk=100, encoder_hidden=(200, 200),
                           decoder_hidden=(200, 200), warmup_steps=100,
                           checkpoint_dir=str(work / ck))
        trainer = SvaeTrainer(mc, tc, input_dim=784)
        t0 = time.perf_counter()
        state = trainer.fit(train.astype(np.float32), test.astype(np.float32))
        return trainer, state, (time.perf_counter() - t0) * 1e3 / steps

    combine.launches = decoder_mlp.launches = 0
    whole, s_whole, ms_whole = mnist_fit(200, "E")
    fwd, dec = combine.launches, decoder_mlp.launches
    _, _, ms_first = mnist_fit(100, "F")
    resumed, s_res, ms_res = mnist_fit(200, "F")
    assert fwd > 0 and dec > 0, (fwd, dec)
    assert whole.warmup_info is not None and resumed.warmup_info is None
    assert same(s_whole, s_res), "mnist width: the per-step engine's resumed fit differs"
    print(f"phase L: SvaeTrainer mnist-svae width (per-step engine, fused combine and MLP "
          f"decoder: {fwd} combine / {dec} decoder forward launches in the whole fit), "
          f"100 warmup + 200 steps vs 100 warmup + 100 + resume 100 (no second warmup): "
          f"bit-equal; ms a step (fit wall over its steps, warmup and evaluations "
          f"included): whole {ms_whole:.3f}, first leg {ms_first:.3f}, resumed leg "
          f"{ms_res:.3f}; {card}", flush=True)

    # 4. GmmTrainer: mixstep from a k-means++ start, then the estep kernel
    train, test = load_pinwheel(num_classes=5, num_per_class=100, seed=0)
    prior = gmm.make_prior(10, 2, kappa=0.05, device=dev)
    start = GmmTrainState(nat=init_variational_kmeanspp(prior, train, seed=0), step=0)

    def gmm_fit(steps, ck, **kw):
        tc = TrainerConfig(steps=steps, eval_every=100, rho=1.0,
                           checkpoint_dir=str(work / ck) if ck else "", **kw)
        trainer = GmmTrainer(tc, 10, 2, prior=prior, fused=kw.get("engine") == "step")
        t0 = time.perf_counter()
        state = trainer.fit(train.astype(np.float32), test.astype(np.float32), state=start)
        return trainer, state, (time.perf_counter() - t0) * 1e3 / (steps - trainer._start)

    mixstep.launches = 0
    whole, s_whole, ms_whole = gmm_fit(300, "G", engine="kernel")
    _, _, ms_first = gmm_fit(200, "H", engine="kernel")
    _, s_res, ms_res = gmm_fit(300, "H", engine="kernel")
    mix = mixstep.launches
    assert whole.engine == "kernel" and mix == 6 and same(s_whole, s_res), mix
    estep.launches = 0
    fused, _, ms_fused = gmm_fit(100, "", engine="step")
    assert fused.engine == "step" and estep.launches == 100, estep.launches
    print(f"phase L: GmmTrainer pinwheel-gmm (k-means++ start) 300 steps vs 200 + resume "
          f"(mixstep, {mix} launches): bit-equal, test evidence/pt "
          f"{whole.best['best_value']:.5f}; ms a step: whole {ms_whole:.4f}, first leg "
          f"{ms_first:.4f}, resumed leg {ms_res:.4f}; fused=True per-step engine "
          f"{estep.launches} estep launches in 100 steps, {ms_fused:.4f} ms a step; {card}",
          flush=True)
    print(f"phase L: training legs done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 5. phase D's mnist-svae bundle, served
    x_train, x_test, _, _, labels = load_mnist(seed=0, return_labels=True)
    x_train, x_test = x_train.astype(np.float32), x_test.astype(np.float32)
    live = serve.load_bundle(served["bundle"], device="cuda")
    host = serve.load_bundle(served["bundle"], device="cpu")
    assert all(torch.equal(p, q.to(dev)) for (_, p), (_, q)
               in zip(flatten(live._nat), flatten(served["state"].pgm_nat)))
    big = np.concatenate([x_test, x_train, x_train])[:8193]
    full = live.encode(big)
    tol = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_serve.py's
    for n in (1, 33, 512, 8193):
        got = live.encode(big[:n])
        np.testing.assert_allclose(got["z_mean"], full["z_mean"][:n], **tol)
        assert got["z_mean"].shape == (n, 8) and got["component"].shape == (n,)
    on_cpu = host.encode(big)
    np.testing.assert_allclose(full["z_mean"], on_cpu["z_mean"], **tol)
    np.testing.assert_allclose(full["responsibilities"], on_cpu["responsibilities"], **tol)
    # Components may differ only where the two most responsible components
    # lie within the responsibilities' tolerance of each other.
    tie = 2 * (tol["rtol"] + tol["atol"])
    differ = full["component"] != on_cpu["component"]
    assert not np.any(differ & ~_near_ties(on_cpu["responsibilities"], tie)), \
        "the cuda and cpu servers' components differ beyond near ties"
    comp = live.cluster(x_test)
    purity = evaluation.cluster_purity(np.eye(10)[comp], labels)
    with torch.no_grad():  # the entry's own assignment (measure_mnist.quality)
        st = served["state"]
        pot_h, pot_p = nets.encoder_apply(st.nn_params["encoder"], torch.tensor(x_test,
                                                                                device=dev))
        resp = torch.exp(sin_combine(pot_h, pot_p, gmm.expected_params(st.pgm_nat)).log_resp)
    entry_comp = resp.argmax(-1).cpu().numpy()
    moved = comp != entry_comp
    assert not np.any(moved & ~_near_ties(resp.cpu().numpy(), tie)), \
        "server.cluster differs from the entry's assignment beyond near ties"
    assert abs(purity - served["purity"]) <= moved.sum() / len(labels) + 1e-12, \
        (purity, served["purity"])
    scores = live.score(x_test, seed=0, num_samples=100)
    se = float(scores.std() / np.sqrt(len(scores)))
    assert abs(float(scores.mean()) - served["iw"]) <= 3 * se, (scores.mean(), served["iw"])
    mask = np.ones_like(x_test[:512])
    mask[:, 392:] = 0.0  # the bottom half of each image is missing
    for mode in ("mean", "map"):
        filled = live.impute(x_test[:512], mask, mode=mode)
        assert np.array_equal(filled[:, :392], x_test[:512, :392]), mode
        assert np.all((filled >= 0) & (filled <= 1))
    gx, gz, gl = live.generate(12, seed=0)
    assert gx.shape == (12, 784) and np.all(np.isfinite(gx)) and np.all((gx >= 0) & (gx <= 1))
    print(f"phase L: mnist-svae bundle served on {live.device}: requests of 1, 33, 512, 8193 "
          f"rows equal the 8193-row answer's rows (rtol 1e-5); cuda vs cpu server at 8193 "
          f"rows z_mean max abs diff {np.abs(full['z_mean'] - on_cpu['z_mean']).max():.3e}, "
          f"components differing {int(differ.sum())} (near ties only); cluster purity "
          f"{purity:.4f} (phase D {served['purity']:.4f}, {int(moved.sum())} rows assigned "
          f"otherwise, near ties); score mean {scores.mean():.4f} "
          f"+- {se:.4f} (100 samples; the entry's IW/pt {served['iw']:.4f}); impute mean and "
          f"map keep the observed pixels bit for bit; generate(12) finite; {card}",
          flush=True)

    # 6. the exported tier, served by a fresh child without the model modules;
    # both tiers graphed (the default on the card) against eager, bit for bit
    live = serve.load_bundle(served["bundle"], buckets=(32, 512), device="cuda")
    live_eager = serve.load_bundle(served["bundle"], buckets=(32, 512), device="cuda",
                                   graph=False)
    assert live.route == "graphed" and live_eager.route.startswith("eager"), live.route
    t0 = time.perf_counter()
    serve.export_serving(live, work / "exported", buckets=(32, 512))
    t_export = time.perf_counter() - t0
    inputs, want = {}, {}
    lat_live = {"eager": {}, "graphed": {}}
    for b in (32, 512, 1024):  # 1024: two pieces at the top bucket, one graph
        x = np.concatenate([x_test, x_test])[:b]
        m = np.ones_like(x)
        m[:, 392:] = 0.0
        inputs[f"x{b}"], inputs[f"mask{b}"] = x, m
        calls = {srv.route: {"encode": lambda s=srv: s.encode(x),
                             "reconstruct": lambda s=srv: s.reconstruct(x),
                             "impute": lambda s=srv: s.impute(x, m),
                             "score": lambda s=srv: s.score(x, seed=3)}
                 for srv in (live, live_eager)}
        graphed, eager = calls[live.route], calls[live_eager.route]
        for name, call in graphed.items():
            got, ref = call(), eager[name]()
            pairs = got.items() if isinstance(got, dict) else [("", got)]
            for key, value in pairs:
                assert np.array_equal(value, ref[key] if key else ref), \
                    f"phase L: live {name} at {b} rows: graphed differs from eager ({key})"
                if b < 1024:
                    want[f"{name}_{b}_{key}"] = value
            if b < 1024:
                for route, c in (("eager", eager), ("graphed", graphed),
                                 ("graphed", graphed), ("eager", eager)):
                    lat_live[route].setdefault(f"{name}_{b}", []).append(
                        median_ms(c[name]))
    np.savez(work / "inputs.npz", **inputs)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _EXPORTED_CHILD, str(work / "exported"),
                          str(work / "inputs.npz"), str(work / "answers.npz")],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"phase L: the exported tier's child exited {out.returncode}:\n"
                           f"{out.stderr[-4000:]}")
    child = json.loads([ln for ln in out.stdout.splitlines()
                        if ln.startswith("RESULT ")][-1][len("RESULT "):])
    t_child = time.perf_counter() - t0
    assert child["models_blocked"] and child["device"].startswith("cuda"), child
    assert child["routes"]["graphed"] == "graphed", child["routes"]
    assert all(child["equal"].values()), \
        f"phase L: exported graphed differs from eager: {child['equal']}"
    answers = np.load(work / "answers.npz")
    assert set(answers.files) == set(want), (sorted(answers.files), sorted(want))
    worst = 0.0
    for key, value in want.items():
        got = answers[key]
        if key.startswith("score") or key.endswith("component"):
            assert np.array_equal(got, value), key
        else:
            np.testing.assert_allclose(got, value, rtol=1e-6, atol=1e-6, err_msg=key)
            worst = max(worst, float(np.abs(got - value).max()))
    print(f"phase L: export_serving at buckets (32, 512) on {live.device} in {t_export:.1f} "
          f"s; a fresh process without svax_torch.models served them ({t_child:.1f} s with "
          f"its start, loads and {child['captures']} captures): encode, reconstruct, impute "
          f"within {worst:.3e} of the live server, score and components bit-equal; both "
          f"tiers graphed == eager bit for bit at 32, 512 and 1024 rows (two pieces); "
          f"live graphs: {live.graphs.captures} captures, {live.graphs.pool_bytes} bytes "
          f"reserved; {card}", flush=True)

    def turns(v):
        return "/".join(f"{t:.3f}" for t in v)

    for b in (32, 512):
        print(f"phase L: latency ms at bucket {b} (median of 5, host arrays back, in turns), "
              f"live graphed | eager, exported graphed | eager: " + ", ".join(
                  f"{name} {turns(lat_live['graphed'][f'{name}_{b}'])} | "
                  f"{turns(lat_live['eager'][f'{name}_{b}'])}, "
                  f"{turns(child['latency_ms']['graphed'][f'{name}_{b}'])} | "
                  f"{turns(child['latency_ms']['eager'][f'{name}_{b}'])}"
                  for name in ("encode", "reconstruct", "impute", "score"))
              + f"; {card}", flush=True)
    print(f"phase L: {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase M's bars for the bf16-product mode against its plain version, per
# quantity (rtol, atol), beside the f32 mode's bars of phases 4 and A. With
# operands of 8 significant bits, an f32 sum taken in another order can
# move an activation across a bf16 rounding boundary, and the next product
# then differs by a bf16 ulp of that operand: the gap is set by where the
# rounding lands, not by the f32 sums (PERF.md, PR 17).
BF16_TINY_TOL = {"params": (5e-4, 5e-5), "adam m": (5e-4, 5e-4), "adam v": (5e-3, 1e-6),
                 "naturals": (2e-4, 2e-4), "recon": (2e-3, 0.0), "local_kl": (2e-3, 2e-3)}
BF16_FLEX_TOL = {"params": (5e-4, 1e-4), "adam m": (5e-4, 5e-4), "naturals": (2e-3, 2e-3),
                 "recon": (2e-3, 2e-3), "local_kl": (2e-3, 2e-3), "neg_loss": (2e-3, 2e-3),
                 "rho": (1e-6, 1e-6)}


def bf16_steps_phase(card: str) -> list:
    """Phase M (1): tinystep's and flexstep's bf16-product mode against their
    plain versions, reruns, ptxas lines and per-step times; returns their
    entries of the kernels line (launches set by phases 5 and B)."""
    import numpy as np
    import torch

    from svax_torch.data import load_dataset
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.measure_auto import mlp_fmas, step_fmas
    from svax_torch.measure_mnist import BF16_FLOPS
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import flexstep, tinystep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    dev = torch.device("cuda", 0)
    c16 = tinystep.DEFAULT_CLUSTER
    instances_ptxas("M", "tinystep_kernel", {(50, 50, c16, 1), (16, 16, c16, 1)})
    instances_ptxas("M", "flexstep_kernel", {(d, c16, 1) for d in flexstep.LATENT_DIMS},
                    {(d, c, b) for d in (2, 3, 4) for c in tinystep.CLUSTER_SIZES
                     for b in (0, 1)})

    def check(name, st_k, st_p, met_k, met_p, groups, tol) -> dict:
        e = {}
        for group, tk, tp in groups:
            e[group] = max(close(f"{name} {group}", a_, b_, *tol[group])
                           for a_, b_ in zip(tk, tp))
        for key in ("recon", "local_kl", "neg_loss", "rho"):
            if key in tol:
                e[key] = close(f"{name} {key}", met_k[key], met_p[key], *tol[key])
        return e

    def tree_groups(st_k, st_p, adam_v=True):
        g = [("params", flat(st_k.nn_params), flat(st_p.nn_params)),
             ("adam m", flat(st_k.opt_state.mu), flat(st_p.opt_state.mu)),
             ("naturals", nat_leaves(st_k.pgm_nat), nat_leaves(st_p.pgm_nat))]
        if adam_v:
            g.append(("adam v", flat(st_k.opt_state.nu), flat(st_p.opt_state.nu)))
        return g

    def rel_to_f32(st_b, st_f) -> float:
        """max |bf16 − f32| / max |f32| over the parameters: the modes differ."""
        return max(rel_err(a_, b_) for a_, b_ in zip(flat(st_b.nn_params),
                                                    flat(st_f.nn_params)))

    # tinystep at full pinwheel width, GMM and SMM, and at 16-16.
    train, _ = load_pinwheel(seed=0)
    n, k, s, t = train.shape[0], 10, 4, 3
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(300)
    eps = torch.tensor(rng.standard_normal((t, s, n, k, 2)), dtype=torch.float32, device=dev)
    aug_eps = torch.tensor(rng.standard_normal((t, n, 2)), dtype=torch.float32, device=dev)

    def tiny_setup(hidden):
        config = SvaeConfig(latent_dim=2, num_components=k, num_samples=s, num_total=n)
        prior = gmm.make_prior(k, 2, kappa=0.05)
        state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config, prior,
                                     hidden, hidden)
        return svae_step.state_to(state, dev), svae_step.nat_to(prior, dev)

    errs = {}
    for name, hidden, smm in (("GMM 50-50", (50, 50), {}),
                              ("SMM dof 4, 2 rounds, full chain, 50-50", (50, 50),
                               dict(dof=4.0, smm_iters=2)),
                              ("GMM 16-16", (16, 16), {})):
        state, prior = tiny_setup(hidden)
        kw = dict(lr=1e-3, rho=0.05, t_steps=t, aug_noise=0.4, eps=eps, aug_eps=aug_eps,
                  **smm)
        st_k, met_k = tinystep.train_chunk(state, prior, x, nn_precision="default", **kw)
        st_k2, _ = tinystep.train_chunk(state, prior, x, nn_precision="default", **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a_, b_) for a_, b_ in zip(leaves(st_k), leaves(st_k2))), \
            f"tinystep bf16 {name}: reruns differ"
        st_p, met_p = tinystep.train_chunk_plain(state, prior, x, nn_precision="default", **kw)
        st_f, _ = tinystep.train_chunk_plain(state, prior, x, **kw)
        e = check(f"tinystep bf16 {name}", st_k, st_p, met_k, met_p,
                  tree_groups(st_k, st_p), BF16_TINY_TOL)
        errs[name] = e
        print(f"phase M: tinystep bf16-product mode (cluster {c16}) vs plain, T={t} at N={n} "
              f"K={k} S={s} sigma=0.4, {name}: "
              + ", ".join(f"{g} max abs err {v:.3e}" for g, v in e.items())
              + f"; reruns bit-equal; kernel vs the plain f32 step: params "
              f"{rel_to_f32(st_k, st_f):.3e} of the largest (bars {BF16_TINY_TOL})",
              flush=True)
    tiny_err = max(v for e in errs.values() for g, v in e.items()
                   if g in ("params", "adam m", "adam v", "naturals"))

    # flexstep at full auto width, and at d = 2 and d = 6 small.
    auto_x, _, _ = load_dataset("auto", seed=0)
    full = dict(d=4, d_in=8, k=10, s=4, hidden=(100, 100), m=64)

    def flex_setup(d, d_in, k, s, hidden, m, data=None):
        gen = torch.Generator().manual_seed(0)
        xx = torch.tensor(data, dtype=torch.float32) if data is not None else (
            torch.randn(120, d_in, generator=gen))
        config = SvaeConfig(latent_dim=d, num_components=k, num_samples=s,
                            num_total=xx.shape[0])
        prior = gmm.make_prior(k, d, kappa=0.05)
        state = svae_step.init_state(gen, d_in, config, prior, hidden, hidden)
        return svae_step.state_to(state, dev), svae_step.nat_to(prior, dev), xx.to(dev)

    def flex_stack(xx, t_, m, seed):
        r = np.random.default_rng(seed)
        return xx[torch.tensor(r.integers(0, xx.shape[0], (t_, m)), device=dev)].contiguous()

    ferrs = {}
    for name, c, data in (("auto width", full, auto_x),
                          ("d=2", dict(d=2, d_in=3, k=5, s=2, hidden=(16, 16), m=32), None),
                          ("d=6", dict(d=6, d_in=8, k=3, s=2, hidden=(24, 24), m=32), None)):
        state, prior, xx = flex_setup(**c, data=data)
        batches = flex_stack(xx, t, c["m"], 1)
        r = np.random.default_rng(2)
        feps = torch.tensor(r.standard_normal((t, c["s"], c["m"], c["k"], c["d"])),
                            dtype=torch.float32, device=dev)
        kw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=xx.shape[0], eps=feps)
        st_k, met_k = flexstep.train_chunk(state, prior, batches, nn_precision="default",
                                           **kw)
        st_k2, _ = flexstep.train_chunk(state, prior, batches, nn_precision="default", **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a_, b_) for a_, b_ in zip(leaves(st_k), leaves(st_k2))), \
            f"flexstep bf16 {name}: reruns differ"
        st_p, met_p = flexstep.train_chunk_plain(state, prior, batches,
                                                 nn_precision="default", **kw)
        st_f, _ = flexstep.train_chunk_plain(state, prior, batches, **kw)
        e = check(f"flexstep bf16 {name}", st_k, st_p, met_k, met_p,
                  tree_groups(st_k, st_p, adam_v=False), BF16_FLEX_TOL)
        ferrs[name] = e
        print(f"phase M: flexstep bf16-product mode (cluster {c16}) vs plain, T={t} at "
              f"{name} {c}: " + ", ".join(f"{g} max abs err {v:.3e}" for g, v in e.items())
              + f"; reruns bit-equal; kernel vs the plain f32 step: params "
              f"{rel_to_f32(st_k, st_f):.3e} of the largest (bars {BF16_FLEX_TOL})",
              flush=True)
    flex_err = max(ferrs["auto width"][g] for g in ("params", "adam m", "naturals"))

    # Per step, each mode in turns (f32, bf16, bf16, f32), and the plain
    # bf16 step. The bound counts the MLP products at the bf16 tensor-core
    # peak, their operands' type (the kernels still run them as f32 FMAs).
    state, prior = tiny_setup((50, 50))
    t_kernel, t_plain = 200, 20
    base = dict(lr=1e-3, rho=0.05, aug_noise=0.4)
    tiny_ms = {"highest": [], "default": []}
    for mode in ("highest", "default", "default", "highest"):
        tiny_ms[mode].append(time_per_step(lambda: tinystep.train_chunk(
            state, prior, x, t_steps=t_kernel, nn_precision=mode, **base), t_kernel))
    tiny_plain = time_per_step(lambda: tinystep.train_chunk_plain(
        state, prior, x, t_steps=t_plain, nn_precision="default", **base), t_plain)
    p_tiny = n_params(state.nn_params)
    tiny_bound = bound(2 * (mlp_fmas([2, 50, 50, 4], s * n * k, True)
                            + mlp_fmas([2, 50, 50, 4], n, False)),
                       4 * (6 * p_tiny + 2 * n + 3 * k * 9) / t_kernel + 12, BF16_FLOPS)
    state, prior, xx = flex_setup(**full, data=auto_x)
    big, small = flex_stack(xx, 500, 64, 3), flex_stack(xx, 20, 64, 4)
    fkw = dict(lr=1e-3, rho=0.2, rho_decay=1e-3, num_total=xx.shape[0], num_samples=4)
    flex_ms = {"highest": [], "default": []}
    for mode in ("highest", "default", "default", "highest"):
        flex_ms[mode].append(time_per_step(lambda: flexstep.train_chunk(
            state, prior, big, nn_precision=mode, **fkw), 500))
    flex_plain = time_per_step(lambda: flexstep.train_chunk_plain(
        state, prior, small, nn_precision="default", **fkw), 20)
    p_flex = n_params(state.nn_params)
    flex_bound = bound(2 * step_fmas(4, 8, 10, 4, 64, 100),
                       4 * 64 * 8 + 4 * (6 * p_flex + 3 * 10 * (3 + 4 + 16)) / 500 + 16,
                       BF16_FLOPS)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    print(f"phase M: per step on the card, f32 mode vs bf16-product mode in turns "
          f"(f32, bf16, bf16, f32): tinystep at pinwheel width (chunks of {t_kernel}) "
          f"{tiny_ms['highest']} vs {tiny_ms['default']} ms, plain bf16 step "
          f"{tiny_plain:.4f} ms, bound (bf16 products) {tiny_bound[0] * 1e3:.3f} us "
          f"({tiny_bound[1]}); flexstep at auto width "
          f"(chunks of 500) {flex_ms['highest']} vs {flex_ms['default']} ms, plain bf16 "
          f"step {flex_plain:.4f} ms, bound (bf16 products) {flex_bound[0] * 1e3:.3f} us "
          f"({flex_bound[1]}); {card}",
          flush=True)
    return [
        {"name": "tinystep_bf16", "route": "cuda", "source": "svax_torch/ops/csrc/tinystep.cu",
         "replaces": "svax/ops/tinystep_pallas.py:621", "launches": 0,
         "max_abs_err": tiny_err, "ms": med(tiny_ms["default"]), "plain_ms": tiny_plain,
         "bound_ms": tiny_bound[0], "bound_by": tiny_bound[1], "library_ms": None,
         "cluster": c16, "mode": "bf16 products (nn_precision default)"},
        {"name": "flexstep_bf16", "route": "cuda", "source": "svax_torch/ops/csrc/flexstep.cu",
         "replaces": "svax/ops/flexstep_pallas.py:374", "launches": 0,
         "max_abs_err": flex_err, "ms": med(flex_ms["default"]), "plain_ms": flex_plain,
         "bound_ms": flex_bound[0], "bound_by": flex_bound[1], "library_ms": None,
         "cluster": c16, "mode": "bf16 products (nn_precision default)"},
    ]


def slice_j_paths_phase(card: str, bigk_ms: float) -> None:
    """Phase M (3, 4, 6): the full head at mnist-svae's width and the sampled
    estimator at bigk-dp's, through the entry on the card, then a full-head
    ReLU bundle served live and from its exported tier. ``bigk_ms`` is phase
    F's weighted step, printed beside the sampled one."""
    import numpy as np
    import torch

    from svax_torch import serve, train_svae
    from svax_torch.data import load_dataset
    from svax_torch.measure_mnist import quality
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import combine, decoder_mlp
    from svax_torch.pgm import gmm
    from svax_torch.train import loop, svae_step

    dev = torch.device("cuda", 0)
    counters = (combine, decoder_mlp)

    def reset():
        for mod in counters:
            mod.launches = mod.backward_launches = 0
        combine.lean_backward_launches = 0

    # The Student-t prior on the flagship at its config: tinystep's SMM
    # branch in the bf16-product mode.
    from svax_torch.ops import tinystep

    tinystep.launches = tinystep.launches_bf16 = 0
    smm = train_svae.main(["--config", "pinwheel-svae", "--smm-dof", "4", "--steps", "2000",
                           "--device", "cuda", "--seed", "0", "--iw-samples", "0"])
    rows = smm["rows"]
    assert smm["kernel"] == "tinystep" and tinystep.launches_bf16 == 2, tinystep.launches_bf16
    assert all(math.isfinite(v) for r in rows for v in r.values())
    start, end = smm["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    assert rows[-1]["elbo"] > rows[0]["elbo"] and end > start, (rows, start)
    print(f"phase M: pinwheel-svae --smm-dof 4 at the config's nn_precision default "
          f"(tinystep's SMM branch, bf16 products; 2000 steps): {tinystep.launches_bf16} "
          f"launches, {smm['steps_per_s']:.1f} steps/s, test ELBO/pt {start:.4f} -> "
          f"{end:.4f}; {card}", flush=True)

    # (3) mnist-svae's width with the full head: the per-step engine, the
    # plain combine (the fused one takes the diagonal head only) and the
    # MLP-decoder kernel; cut to 60 warmup + 60 joint steps (the plain
    # combine's entry-unrolled d = 8 Cholesky holds the host to ~6 steps/s).
    argv = ["--config", "mnist-svae", "--encoder-head", "full", "--fused-mlp-decoder",
            "--warmup-steps", "60", "--steps", "60", "--device", "cuda", "--seed", "0",
            "--iw-samples", "0"]
    reset()
    run = train_svae.main(argv)
    comb, dec = (combine.launches, combine.backward_launches), (
        decoder_mlp.launches, decoder_mlp.backward_launches)
    assert run["kernel"] == loop.PER_STEP and comb == (0, 0) and min(dec) > 0, (comb, dec)
    rows = run["rows"]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run["state"]))
    start, end = run["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    purity, used = quality(run, 0, head="full")
    print(f"phase M: mnist-svae --encoder-head full (784 -> 200-200, d=8, K=10, minibatch "
          f"256; 60 warmup + 60 steps, seed 0, per-step engine): combine launches {comb}, "
          f"MLP-decoder launches {dec} (forward, backward); {run['steps_per_s']:.1f} steps/s, "
          f"test ELBO/pt {start:.4f} -> {end:.4f}, purity {purity:.4f}, {used} of 10 "
          f"components in use; {card}", flush=True)
    assert end > start + 100.0, f"full head: test ELBO/pt {start} -> {end}"
    full_state = run["state"]

    # (4) bigk-dp's width with the sampled estimator: S·N = 1024 decoder rows
    # a step in place of S·N·K = 102,400; cut to 20 warmup + 20 steps (the
    # plain combine at K = 100, d = 10 holds the host to ~4 steps/s).
    argv = ["--config", "bigk-dp", "--recon-mode", "sampled", "--warmup-steps", "20",
            "--steps", "20", "--eval-every", "10", "--device", "cuda", "--seed", "0",
            "--iw-samples", "0"]
    reset()
    run = train_svae.main(argv)
    rows = run["rows"]
    assert run["kernel"] == loop.PER_STEP and decoder_mlp.launches == 0, decoder_mlp.launches
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert all(bool(torch.isfinite(t_).all()) for t_ in leaves(run["state"]))
    start, end = run["init_test_elbo_per_point"], rows[-1]["test_elbo_per_point"]
    assert end > start, f"sampled: test ELBO/pt {start} -> {end}"
    print(f"phase M: bigk-dp --recon-mode sampled (K=100, d=10, minibatch 1024, 200-200; "
          f"20 warmup + 20 steps, seed 0, per-step engine, plain combine): test ELBO/pt "
          f"{start:.4f} -> {end:.4f}, {1e3 / run['steps_per_s']:.3f} ms a step (phase F's "
          f"weighted step {bigk_ms:.3f} ms); {card}", flush=True)

    # (6) a full-head ReLU bundle at mnist width: 20 steps from phase M (3)'s
    # state with ReLU nets, saved, served on cuda, exported and served again.
    train, test, meta = load_dataset("mnist", seed=0)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    config = SvaeConfig(latent_dim=8, num_components=10, num_samples=1, num_total=x.shape[0],
                        likelihood="bernoulli", nn_compute_dtype="bfloat16",
                        encoder_head="full", activation="relu")
    prior = gmm.make_prior(10, 8, alpha=1.0, kappa=0.05, device=dev)
    runner = loop.make_step_runner(config, prior, lr=1e-3, rho=0.1, batch_size=256)
    state, mets = runner(full_state, x, 20, seed=0)
    assert bool(torch.isfinite(mets["elbo"]).all())
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_M"
    shutil.rmtree(work, ignore_errors=True)
    spec = serve.ModelSpec(input_dim=784, latent_dim=8, num_components=10,
                           likelihood="bernoulli", encoder_hidden=(200, 200),
                           decoder_hidden=(200, 200), activation="relu", encoder_head="full",
                           num_total=x.shape[0])
    serve.save_bundle(work / "bundle", state, spec)
    live = serve.load_bundle(work / "bundle", buckets=(32,), device="cuda")
    serve.export_serving(live, work / "exported", buckets=(32,))
    aot = serve.load_exported(work / "exported")
    xt = test.astype(np.float32)
    worst = 0.0
    for b in (32,):
        q = xt[:b]
        m = np.ones_like(q)
        m[:, 392:] = 0.0
        pairs = {"encode": (live.encode(q), aot.encode(q)),
                 "reconstruct": (live.reconstruct(q), aot.reconstruct(q)),
                 "impute": (live.impute(q, m), aot.impute(q, m)),
                 "score": (live.score(q, seed=3), aot.score(q, seed=3))}
        for name, (want, got) in pairs.items():
            for key in (want if isinstance(want, dict) else [""]):
                w_, g_ = (want[key], got[key]) if key else (want, got)
                if name == "score" or key == "component":
                    assert np.array_equal(g_, w_), (name, key, b)
                else:
                    np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=1e-6,
                                               err_msg=f"{name} {key} {b}")
                    worst = max(worst, float(np.abs(g_ - w_).max()))
    print(f"phase M: a full-head ReLU bundle (mnist width, 20 steps on from (3)'s state) "
          f"served on {live.device}: the exported tier at bucket 32 against the live "
          f"one: encode, reconstruct, impute within {worst:.3e}, score and components "
          f"bit-equal; {card}", flush=True)


# The mixture legs' floors, measured on the CPU over generator seeds 0-15
# (``compare.mixture_seeds(dataset, 16, "cpu")`` for auto and mnist;
# float32, the leg's K initial rows drawn by torch.Generator on the CPU,
# where the card's generator draws others): the worst predictive less 0.05
# nat. Seeds 0-3 alone (BMM worst -257.205, GMM
# -9.144) do not bound the fixed points a draw lands: 4 of the 16 BMM seeds
# and 3 GMM seeds fall under them.
BMM_FLOOR = -280.929  # seeds 0-15: -227.962 .. -280.879 (two at -227.962)
GMM_AUTO_FLOOR = -9.397  # seeds 0-15: -8.735 .. -9.347


def compare_phase(card: str) -> None:
    """N. the three-model comparison through svax_torch.compare (docstring)."""
    import torch

    from svax_torch import compare
    from svax_torch.data import load_dataset
    from svax_torch.ops import flexstep, tinystep

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_N"
    shutil.rmtree(work, ignore_errors=True)
    out = str(work / "comparison_torch.json")

    def legs(tag: str, res: dict) -> None:
        for leg in res["legs"]:
            print(f"phase N: {tag} {leg['leg']} seed {leg['seed']}: {leg['seconds']:.2f} s "
                  f"on {leg['engine']}; {card}", flush=True)

    def finite(row: dict) -> None:
        vals = [row["svae"]["iw_best"], row["vae"]["iw_best"], row["svae"]["iw_final"],
                row["vae"]["iw_final"], *(v for v in row["gmm"].values()
                                          if isinstance(v, float))]
        assert all(math.isfinite(v) for v in vals), row

    # (1) pinwheel and auto, --quick, on the kernels' f32 mode
    tinystep.launches = tinystep.launches_bf16 = 0
    flexstep.launches = flexstep.launches_bf16 = 0
    t0 = time.perf_counter()
    quick = compare.main(["--quick", "--engine", "kernel", "--datasets", "pinwheel", "auto",
                          "--out", out])
    quick_s = time.perf_counter() - t0
    tiny_n, flex_n = tinystep.launches, flexstep.launches
    assert tiny_n >= 2 and tinystep.launches_bf16 == 0, \
        f"tinystep launched {tiny_n} times in its f32 mode through compare"
    assert flex_n >= 2 and flexstep.launches_bf16 == 0, \
        f"flexstep launched {flex_n} times in its f32 mode through compare"
    for ds, kernel in (("pinwheel", "tinystep"), ("auto", "flexstep")):
        row = quick[ds]["row"]
        budget = row["budget"]
        assert (budget["svae_engine"], budget["svae_kernel"],
                budget["svae_kernel_mode"]) == ("kernel", kernel, "f32"), budget
        finite(row)
        legs(f"{ds} --quick", quick[ds])
        print(f"phase N: {ds} --quick row: svae {row['svae']['iw_best']} vae "
              f"{row['vae']['iw_best']} gmm {row['gmm']['exact_predictive']}", flush=True)
    written = json.loads(Path(out).read_text())
    assert set(written) == {"pinwheel", "auto"}, set(written)
    print(f"phase N: compare --quick --engine kernel (pinwheel, auto) in {quick_s:.1f} s: "
          f"tinystep {tiny_n} launches, flexstep {flex_n} (f32 mode); {card}", flush=True)

    # (2) mnist: the SVAE leg cut to 20 + 20 steps, the VAE at --quick, the
    # Bernoulli mixture at its full 300 steps
    t0 = time.perf_counter()
    spec = dict(compare.quick_spec(compare.SPECS["mnist"]),
                bmm_steps=compare.SPECS["mnist"]["bmm_steps"])
    mnist = compare.run_dataset("mnist", engine="kernel", device="cuda", spec=spec,
                                svae_cut=dict(warmup=20, steps=20, eval_every=20))
    row = mnist["row"]
    assert row["budget"]["svae_engine"] == "step", row["budget"]
    assert row["budget"]["svae_engine_reason"] == compare.WARMUP_REASON
    finite(row)
    legs("mnist (svae 20 + 20 steps, vae --quick, bmm 300)", mnist)
    bmm = row["gmm"]["bernoulli_mixture_exact_predictive"]
    assert bmm > BMM_FLOOR, f"Bernoulli mixture {bmm} under its CPU floor {BMM_FLOOR}"
    train, test, _ = load_dataset("mnist", seed=0)
    x = torch.tensor(train, dtype=torch.float32, device="cuda")
    xt = torch.tensor(test, dtype=torch.float32, device="cuda")
    ref_row, _ = compare.bmm_leg(x, xt, 300, rows=compare.REFERENCE_INIT_ROWS["mnist"])
    ref_bmm = ref_row["bernoulli_mixture_exact_predictive"]
    assert abs(ref_bmm - (-227.946)) < 0.1, f"Bernoulli mixture from the reference's rows {ref_bmm}"
    print(f"phase N: mnist in {time.perf_counter() - t0:.1f} s: svae {row['svae']['iw_best']} "
          f"(20 + 20 steps) vae {row['vae']['iw_best']} (--quick); Bernoulli mixture {bmm} "
          f"(floor {BMM_FLOOR}), from the reference's rows {ref_bmm} (reference -227.946, "
          f"bar 0.1); {card}", flush=True)

    # (3) auto at its full budget, seed 0
    t0 = time.perf_counter()
    flexstep.launches = flexstep.launches_bf16 = 0
    auto = compare.run_dataset("auto", engine="kernel", device="cuda")
    row = auto["row"]
    assert flexstep.launches >= 12 and flexstep.launches_bf16 == 0, flexstep.launches
    assert row["budget"]["steps"] == 3000 and row["budget"]["iw"] == 1000
    finite(row)
    legs("auto (full budget)", auto)
    svae_iw, vae_iw = row["svae"]["iw_best"], row["vae"]["iw_best"]
    gmm_iw = row["gmm"]["exact_predictive"]
    train, test, _ = load_dataset("auto", seed=0)
    x = torch.tensor(train, dtype=torch.float32, device="cuda")
    xt = torch.tensor(test, dtype=torch.float32, device="cuda")
    ref_gmm = compare.gmm_leg(x, xt, 300, rows=compare.REFERENCE_INIT_ROWS["auto"])[0][
        "exact_predictive"]
    print(f"phase N: auto full budget (seed 0) in {time.perf_counter() - t0:.1f} s: svae "
          f"{svae_iw} (reference -8.945 +- 0.046), vae {vae_iw} (-9.118 +- 0.044), gmm "
          f"{gmm_iw} (floor {GMM_AUTO_FLOOR}; from the reference's rows {ref_gmm}, reference "
          f"-8.969), svae_beats_vae {row['svae_beats_vae']}, flexstep {flexstep.launches} "
          f"launches; {card}", flush=True)
    assert row["svae_beats_vae"], row
    assert abs(svae_iw - (-8.945)) <= 4 * 0.046, svae_iw
    assert abs(vae_iw - (-9.118)) <= 4 * 0.044, vae_iw
    assert gmm_iw > GMM_AUTO_FLOOR, gmm_iw
    assert abs(ref_gmm - (-8.969)) < 0.05, ref_gmm


SWEEP_REF_MEAN, SWEEP_REF_SD, SWEEP_BAR = -5.569, 0.346, -5.41  # 32 seeds, aug0.4+rs2


def studies_phase(card: str) -> dict:
    """O. the seed sweep and reproduce (docstring); returns the launches
    {"tinystep_bf16", "tinystep", "tinystep_smm", "flexstep", "mixstep"}."""
    from svax_torch import reproduce, seed_sweep
    from svax_torch.ops import flexstep, mixstep, tinystep

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_O"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # (1) the sweep: 6 seeds of the shipped recipe on tinystep's bf16 mode
    tinystep.launches = tinystep.launches_bf16 = 0
    t0 = time.perf_counter()
    sweep = seed_sweep.main(["--engine", "kernel", "--variants", "aug0.4+rs2", "--seed-list",
                             *map(str, range(6)), "--nn-precision", "default", "--device",
                             "cuda", "--json", str(work / "seed_sweep_torch.json")])
    sweep_s = time.perf_counter() - t0
    n_bf16 = tinystep.launches_bf16
    assert n_bf16 >= 180 and tinystep.launches == 0, \
        f"the sweep launched tinystep {n_bf16} times in its bf16 mode ({tinystep.launches} f32)"
    res = sweep["results"]["aug0.4+rs2"]
    for r in res["rows"]:
        assert all(math.isfinite(r[k]) for k in ("iw_per_point", "final_elbo_per_point",
                                                 "test_elbo_per_point")), r
        print(f"phase O: sweep seed {r['seed']}: IW/pt {r['iw_per_point']}, ELBO/pt "
              f"{r['final_elbo_per_point']}, test ELBO/pt {r['test_elbo_per_point']}, "
              f"{'CROSS' if r['crossed'] else 'below'} {r['gmm_bar']} in {r['wall_s']} s; "
              f"{card}", flush=True)
    iws = [r["iw_per_point"] for r in res["rows"]]
    mean, floor = sum(iws) / len(iws), SWEEP_REF_MEAN - 3 * SWEEP_REF_SD / math.sqrt(len(iws))
    crossed = sum(iw > SWEEP_BAR for iw in iws)
    print(f"phase O: seed_sweep --engine kernel aug0.4+rs2, seeds 0-5 (15,000 steps, IW 1000, "
          f"bf16 products) in {sweep_s:.1f} s: mean {mean:.4f} +- {res['summary']['sd']} "
          f"(floor {floor:.4f} from the reference's {SWEEP_REF_MEAN} +- {SWEEP_REF_SD} over "
          f"32 seeds), crossing {crossed}/{len(iws)} (reference 13/32), tinystep {n_bf16} launches "
          f"(bf16 mode); {card}", flush=True)
    assert mean >= floor, f"the sweep's mean IW {mean} is under {floor}"
    assert crossed >= 1, f"no seed of {len(iws)} crossed {SWEEP_BAR}: {iws}"

    # (2) reproduce --quick: gmm, svae, auto-tt, serve
    tinystep.launches = tinystep.launches_bf16 = tinystep.launches_smm = 0
    flexstep.launches = flexstep.launches_bf16 = mixstep.launches = 0
    t0 = time.perf_counter()
    # The per-step rows (mnist-svae, bigk-dp: the plain combine, ~4 steps/s)
    # cut to 2 of --quick's 20 steps.
    rep = reproduce.main(["--quick", "--stages", "gmm", "svae", "auto-tt", "serve",
                          "--device", "cuda", "--out", str(work / "reproduce_summary_torch.json"),
                          "--auto-tt-out", str(work / "auto_tt_torch.json")],
                         steps={"mnist-svae": 2, "bigk-dp": 2})
    rep_s = time.perf_counter() - t0
    rows = rep["results"]
    smm_n = tinystep.launches_smm
    counts = {"tinystep_bf16": n_bf16, "tinystep": tinystep.launches - smm_n,
              "tinystep_smm": smm_n, "flexstep": flexstep.launches,
              "mixstep": mixstep.launches}
    for stage, secs in rep["seconds"].items():
        print(f"phase O: reproduce --quick stage {stage}: {secs:.2f} s; {card}", flush=True)
    for name, row in rows.items():
        if isinstance(row, dict):
            print(f"phase O: reproduce row {name}: {json.dumps(row)}", flush=True)
            vals = [v for v in row.values() if isinstance(v, float)]
            assert all(math.isfinite(v) for v in vals), (name, row)
    kernels = {name: rows[name]["kernel"] for name, _, _ in reproduce.SVAE_ROWS}
    assert kernels == {"pinwheel-svae": "tinystep", "auto-svae": "flexstep",
                       "mnist-svae": "per-step", "bigk-dp": "per-step",
                       "pinwheel-svae-smm": "tinystep"}, kernels
    assert rows["auto-time-to-target"]["kernel"] == "flexstep"
    assert rows["serving"]["finite"] and rows["serving"]["bundle_roundtrip"]
    assert rows["pinwheel-gmm"]["components_used"] >= 6, rows["pinwheel-gmm"]
    assert tinystep.launches_bf16 == flexstep.launches_bf16 == 0
    assert counts["tinystep"] >= 2 and counts["tinystep_smm"] >= 1 and \
        counts["flexstep"] >= 2 and counts["mixstep"] >= 1, counts
    print(f"phase O: reproduce --quick (gmm svae auto-tt serve) in {rep_s:.1f} s: launches "
          f"mixstep {counts['mixstep']}, tinystep f32 {counts['tinystep']} (GMM) + "
          f"{smm_n} (SMM), flexstep f32 {counts['flexstep']}; pure GMM predictive "
          f"{rows['pinwheel-gmm']['test_predictive_loglik']:.4f} with "
          f"{rows['pinwheel-gmm']['components_used']} components; serve IW/pt "
          f"{rows['serving']['mean_iw_loglik']} with {rows['serving']['components_used']} "
          f"components; {card}", flush=True)
    return counts

ANOMALY_REF = {"gmm": 0.962, "smm": 0.953}  # BASELINE.md:94-100, outlier box ±30
ROBUST_REF = {"gmm": -7.05, "smm": -7.36}  # BASELINE.md:102-108, clean-test ELBO/pt
IMPUTE_EXPORT_TOL = 1e-6  # phase L's bar for the exported tier against the live one
IMPUTE_ITERS = 3  # phase P's impute rounds (the demo's default is 10)


def demos_phase(card: str) -> dict:
    """P. slice L's demos (docstring); returns the launches {"tinystep",
    "tinystep_smm"}."""
    import torch

    from svax_torch import anomaly_demo, impute_demo, latent_contamination_demo
    from svax_torch import measure_graphs, robustness_demo
    from svax_torch.ops import tinystep

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_P"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tinystep.launches = tinystep.launches_bf16 = tinystep.launches_smm = 0

    # (1) anomaly detection through the served score, the separated regime
    t0 = time.perf_counter()
    an = anomaly_demo.main(["--outlier-scale", "30", "--steps", "15000", "--device", "cuda"])
    an_s = time.perf_counter() - t0
    assert an["kernels"] == {"gmm": "tinystep", "smm": "tinystep"}, an["kernels"]
    for name, ref in ANOMALY_REF.items():
        row = an[name]
        print(f"phase P: anomaly_demo --outlier-scale 30 --steps 15000 {name}: ROC-AUC "
              f"{row['roc_auc']} (reference {ref}, floor {ref - 0.05:.3f}), mean score clean "
              f"{row['mean_score_clean']} outlier {row['mean_score_outlier']}; {card}",
              flush=True)
        assert row["roc_auc"] >= ref - 0.05, (name, row)
    print(f"phase P: anomaly_demo in {an_s:.1f} s; {card}", flush=True)

    # (2) GMM against SMM on a contaminated training set, tanh
    t0 = time.perf_counter()
    rob = robustness_demo.main(["--steps", "3000", "--device", "cuda"])
    rob_s = time.perf_counter() - t0
    assert rob["kernels"] == {"gmm": "tinystep", "smm": "tinystep"}, rob["kernels"]
    for name, ref in ROBUST_REF.items():
        got = rob[name]["clean_test_elbo_per_point"]
        assert all(math.isfinite(v) for v in rob[name].values()), rob[name]
        print(f"phase P: robustness_demo --steps 3000 (tanh) {name}: clean-test ELBO/pt "
              f"{got:.4f} (reference {ref}, bar 1 nat), contaminated-train "
              f"{rob[name]['contaminated_train_elbo_per_point']:.4f}; {card}", flush=True)
        assert abs(got - ref) <= 1.0, (name, got)
    print(f"phase P: robustness_demo in {rob_s:.1f} s: SMM mean E[u] outliers "
          f"{rob['smm']['mean_Eu_outliers']:.4f}, clean {rob['smm']['mean_Eu_clean']:.4f} "
          f"(reference 1.021 / 1.020); {card}", flush=True)

    # (3) the latent-contamination win case at the demo's defaults
    lc = latent_contamination_demo.main(["--device", "cuda", "--json",
                                         str(work / "latent_contamination_torch.json")])
    assert lc["kernel"] == "tinystep", lc["kernel"]
    rows, e_u = lc["clean_test_iw_per_point"], lc["mean_e_u_second_half"]
    assert all(math.isfinite(v) for v in rows.values()), rows
    print(f"phase P: latent_contamination_demo (15,000 + 500 online steps, IW 1000): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rows.items())
          + f"; smm_win_nats {lc['smm_win_nats']:.4f} (reference +0.147), mean E[u] outlier "
          f"rows {e_u['outlier_rows']:.4f} clean rows {e_u['clean_rows']:.4f} (reference "
          f"0.78 / 1.10); seconds " + ", ".join(f"{k} {v:.2f}" for k, v in lc["seconds"].items())
          + f"; {card}", flush=True)
    assert lc["smm_win_nats"] > 0.0, lc["smm_win_nats"]
    assert e_u["outlier_rows"] < e_u["clean_rows"], e_u
    assert lc["online_graph"] == "graphed", lc["online_graph"]
    # ... and its online rules graphed against the eager loop, bit for bit
    for rule, r in measure_graphs.online_routes(torch.device("cuda", 0), steps=200).items():
        assert r["equal"], f"phase P: the graphed {rule} online rule differs from the eager loop"
        assert r["captures"] == 1, (rule, r)
        print(f"phase P: latent demo's {rule} online rule, 200 steps at the demo's defaults: "
              f"graphed == eager bit for bit (naturals and E[u]); ms a step eager "
              + "/".join(f"{v:.4f}" for v in r["eager_ms"]) + ", graphed "
              + "/".join(f"{v:.4f}" for v in r["graphed_ms"])
              + f" (in turns); capture {r['capture_s']:.3f} s, {r['pool_bytes']} bytes "
              f"reserved; {card}", flush=True)

    # (4) the impute endpoint: pinwheel at --quick, mnist at 20 + 20 steps,
    # 3 impute rounds (the demo's 10 cut: the exported tier's trace and load
    # took ~5 s a program at 10 rounds)
    for ds, kw, kernel in (("pinwheel", dict(quick=True), "tinystep"),
                           ("mnist", dict(steps=20, warmup=20), "per-step")):
        t0 = time.perf_counter()
        leg = impute_demo.run_leg(ds, device="cuda", impute_iters=IMPUTE_ITERS, **kw)
        secs = time.perf_counter() - t0
        row, got = leg["row"], leg["kernel"]
        assert got == kernel, (ds, got)
        fills = row["rmse"] if ds == "pinwheel" else row["masked_pixel_nll"]
        assert all(math.isfinite(v) for v in fills.values()), row
        diffs = (row["aot_max_abs_diff"], row["aot_map_max_abs_diff"])
        print(f"phase P: impute_demo {ds} leg ({row['budget']['warmup']} warmup + "
              f"{row['budget']['steps']} steps on {kernel}, {IMPUTE_ITERS} impute rounds) in "
              f"{secs:.1f} s: "
              f"{'rmse' if ds == 'pinwheel' else 'masked_pixel_nll'} {json.dumps(fills)}, "
              f"exported against live {diffs[0]:.3e} / {diffs[1]:.3e} (mean / map; bar "
              f"{IMPUTE_EXPORT_TOL}); seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in leg["seconds"].items())
              + f"; {card}", flush=True)
        assert max(diffs) <= IMPUTE_EXPORT_TOL, (ds, diffs)

    smm_n = tinystep.launches_smm
    counts = {"tinystep": tinystep.launches - smm_n, "tinystep_smm": smm_n}
    assert tinystep.launches_bf16 == 0, tinystep.launches_bf16
    assert counts["tinystep"] >= 4 and counts["tinystep_smm"] >= 2, counts
    print(f"phase P: tinystep launches (f32 mode) {counts['tinystep']} GMM + "
          f"{counts['tinystep_smm']} SMM; {card}", flush=True)
    return counts


# Phase Q's evaluation paths and the launch counters each must show inside
# its graph: the combine forward (in-kernel ε), the decoder_mlp forward
# (bigk-dp) and the row-sum forward in its bf16-operand mode (the big-K f32
# config at "high", --fused-decoder).
EVAL_KERNELS = {"mnist-svae": ("combine.launches",),
                "bigk-dp": ("combine.launches", "decoder_mlp.launches"),
                "bigk-f32": ("combine.launches", "decoder.bf16_launches")}


def graphs_phase(card: str) -> dict:
    """Q. the graphed runners against the eager loop, then the graphed
    held-out evaluation against the eager call (docstring); returns the
    graphed evaluations' launches {"module.counter": n}."""
    import torch

    from svax_torch import measure_graphs as mg

    dev = torch.device("cuda", 0)
    steps = {"mnist-svae": 100, "bigk-dp": 100, "full-head": 10, "vae": 200}
    for path, n in steps.items():
        t0 = time.perf_counter()
        eq = mg.equal_routes(dev, path, (n - n // 4, n // 4))
        assert eq["equal"], f"phase Q: {path}: the graphed chunk differs from the eager loop"
        assert eq["captures"] == 1, (path, eq)
        print(f"phase Q: {path}: graphed == eager bit for bit (states and metrics, {n} steps "
              f"in chunks of {n - n // 4} + {n // 4} in turns, one capture); steps/s eager "
              f"{eq['eager']:.1f} ({n} steps), graphed {eq['graphed']:.1f} (the {n // 4} after "
              f"the capture); capture {eq['capture_s']:.3f} s, {eq['pool_bytes']} bytes "
              f"reserved; {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    launches: dict = {}
    for path, kernels in EVAL_KERNELS.items():
        t0 = time.perf_counter()
        r = mg.eval_routes(dev, path, calls=3)
        assert r["route"] == "graphed", (path, r["route"])
        assert r["equal"], f"phase Q: {path}: the graphed evaluation differs from the eager call"
        assert r["counts_equal"] and r["captures"] == 1, (path, r)
        for name in kernels:
            assert r["launches"].get(name, 0) == 3, (path, name, r["launches"])
        for name in kernels:
            launches[name] = launches.get(name, 0) + r["launches"][name]
        print(f"phase Q: evaluation {path} (make_eval_fn on the kernel engine, the test set): "
              f"graphed == eager bit for bit over 3 calls, the state 10 graphed steps on "
              f"between calls; launches inside the graph equal the eager call's ("
              + ", ".join(f"{k} {r['launches'][k]}" for k in kernels)
              + f"); ms a call eager {r['eager_ms']:.3f}, graphed {r['graphed_ms']:.3f} (host "
              f"read included); capture {r['capture_s']:.3f} s, {r['pool_bytes']} bytes "
              f"reserved; {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    got = timed_fresh("profile_smoke", module="measure_graphs")
    for route, profs in got.items():
        for path, prof in profs.items():
            print(f"phase Q: {path} {route} under torch.profiler ({mg.SMOKE[path]} steps, "
                  f"fresh process): {prof['steps_per_s']:.1f} steps/s, wall "
                  f"{prof['wall_ms']:.4f} ms, device {prof['device_ms']:.4f} ms a step, idle "
                  f"share {100 * prof['idle']:.1f}%; {card}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from svax_torch import train_svae
    from svax_torch.data.pinwheel import load_pinwheel
    from svax_torch.measure_mnist import kernel_resources
    from svax_torch.models.svae import SvaeConfig
    from svax_torch.ops import _build, tinystep
    from svax_torch.pgm import gmm
    from svax_torch.train import svae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

    # 1. the card
    print(f"phase 1: {card}")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"phase 2: built the kernels in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"phase 2: ptxas: {line.strip()}")

    # 3. Philox normals
    n_draws = 1 << 20
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def draws(seed: int) -> torch.Tensor:
        out = torch.empty(n_draws, device=dev, dtype=torch.float32)
        _build.check(lib, lib.philox_normals(seed, 0, ctypes.c_void_p(out.data_ptr()),
                                             n_draws, stream), "philox_normals")
        torch.cuda.synchronize()
        return out

    a, b, c = draws(1234), draws(1234), draws(1235)
    mean, var = float(a.double().mean()), float(a.double().var())
    print(f"phase 3: philox normals mean {mean:.5f} var {var:.5f} "
          f"(|mean| < 0.005, |var - 1| < 0.01)")
    assert abs(mean) < 0.005 and abs(var - 1.0) < 0.01, (mean, var)
    assert torch.equal(a, b), "same seed gave different draws"
    assert not torch.equal(a, c), "seed + 1 gave the same draws"

    # 4. kernel against plain at full width, injected noise
    cfg = {"k": 10, "s": 4, "hidden": (50, 50), "lr": 1e-3, "rho": 0.05,
           "aug": 0.4, "t": 3}
    train, _ = load_pinwheel(seed=0)
    n = train.shape[0]
    config = SvaeConfig(latent_dim=2, num_components=cfg["k"],
                        num_samples=cfg["s"], num_total=n)
    prior = gmm.make_prior(cfg["k"], 2, kappa=0.05)
    state = svae_step.init_state(torch.Generator().manual_seed(0), 2, config,
                                 prior, cfg["hidden"], cfg["hidden"])
    state = svae_step.state_to(state, dev)
    prior = svae_step.nat_to(prior, dev)
    x = torch.tensor(train, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(100)
    eps = torch.tensor(rng.standard_normal((cfg["t"], cfg["s"], n, cfg["k"], 2)),
                       dtype=torch.float32, device=dev)
    aug_eps = torch.tensor(rng.standard_normal((cfg["t"], n, 2)),
                           dtype=torch.float32, device=dev)
    kw = dict(lr=cfg["lr"], rho=cfg["rho"], t_steps=cfg["t"],
              aug_noise=cfg["aug"], eps=eps, aug_eps=aug_eps)
    st_p, met_p = tinystep.train_chunk_plain(state, prior, x, **kw)
    _build.build()  # the kernel library, built in phase 2: sets build_log to its log
    lines = kernel_resources(_build.build_log, "tinystep_kernel")
    if not lines:
        raise RuntimeError("phase 4: no ptxas line for tinystep_kernel in the build log")
    for line in lines:
        print(f"phase 4: ptxas {line}")
    # Every cluster size against the plain version; the default's errors
    # go into the kernels line.
    for cluster in tinystep.CLUSTER_SIZES:
        st_k, met_k = tinystep.train_chunk(state, prior, x, cluster=cluster, **kw)
        torch.cuda.synchronize()
        errs = {}
        groups = [("params", st_k.nn_params, st_p.nn_params, 5e-4, 5e-5),
                  ("adam m", st_k.opt_state.mu, st_p.opt_state.mu, 5e-4, 5e-6),
                  ("adam v", st_k.opt_state.nu, st_p.opt_state.nu, 5e-4, 1e-8)]
        for name, tk, tp, rtol, atol in groups:
            errs[name] = max(close(name, a_, b_, rtol, atol)
                             for a_, b_ in zip(flat(tk), flat(tp)))
        nat_pairs = [(st_k.pgm_nat.dir_nat, st_p.pgm_nat.dir_nat),
                     *zip(st_k.pgm_nat.niw_nat, st_p.pgm_nat.niw_nat)]
        errs["naturals"] = max(close("naturals", a_, b_, 2e-5, 2e-5)
                               for a_, b_ in nat_pairs)
        errs["recon"] = close("recon", met_k["recon"], met_p["recon"], 2e-4, 0.0)
        errs["local_kl"] = close("local_kl", met_k["local_kl"], met_p["local_kl"],
                                 2e-4, 2e-4)
        assert st_k.opt_state.count == st_p.opt_state.count == cfg["t"]
        assert st_k.step == st_p.step == cfg["t"]
        if cluster == tinystep.DEFAULT_CLUSTER:
            max_abs_err = max(errs[g] for g in ("params", "adam m", "adam v", "naturals"))
        print(f"phase 4: kernel (one cluster of {cluster} CTAs) vs plain, T=3 at N=400 K=10 "
              "S=4 50-50 sigma=0.4: "
              + ", ".join(f"{k} max abs err {v:.3e}" for k, v in errs.items())
              + " (params rtol 5e-4 atol 5e-5; m 5e-4/5e-6; v 5e-4/1e-8; "
              "naturals 2e-5/2e-5; recon rtol 2e-4; local_kl 2e-4/2e-4)")

    t_kernel = 200
    cluster_ms = {c: time_per_step(
        lambda: tinystep.train_chunk(state, prior, x, lr=cfg["lr"], rho=cfg["rho"],
                                     t_steps=t_kernel, aug_noise=cfg["aug"], cluster=c),
        t_kernel) for c in tinystep.CLUSTER_SIZES}
    kernel_ms = cluster_ms[tinystep.DEFAULT_CLUSTER]
    t_plain = 20
    plain_ms = time_per_step(
        lambda: tinystep.train_chunk_plain(state, prior, x, lr=cfg["lr"],
                                           rho=cfg["rho"], t_steps=t_plain,
                                           aug_noise=cfg["aug"]),
        t_plain)
    print(f"phase 4: per step on the card: kernel {kernel_ms:.4f} ms "
          f"(chunks of {t_kernel}, cluster of {tinystep.DEFAULT_CLUSTER}; by cluster size "
          + ", ".join(f"{c}: {v:.4f} ms" for c, v in cluster_ms.items())
          + f"), plain {plain_ms:.4f} ms (chunks of {t_plain}); {card}")

    # 5. the main path, at the config's nn_precision "default": tinystep's
    # bf16-product mode
    argv = ["--config", "pinwheel-svae", "--steps", "2000", "--device", "cuda",
            "--seed", "0"]
    tinystep.launches = tinystep.launches_bf16 = 0
    run1 = train_svae.main(argv)
    launches_bf16 = tinystep.launches_bf16
    assert launches_bf16 >= 2 and tinystep.launches == 0, \
        f"tinystep launched {launches_bf16} times in its bf16 mode on the main path"
    rows = run1["rows"]
    assert len(rows) == 2 and all(
        math.isfinite(v) for r in rows for v in r.values()), rows
    assert all(bool(torch.isfinite(t).all()) for t in leaves(run1["state"]))
    assert rows[-1]["elbo"] > rows[0]["elbo"], "training ELBO did not improve"
    run2 = train_svae.main(argv)
    assert all(torch.equal(p, q) for p, q in
               zip(leaves(run1["state"]), leaves(run2["state"]))), \
        "two runs at one seed differ"
    # The f32 mode on the same path: --nn-precision highest.
    tinystep.launches = tinystep.launches_bf16 = 0
    run_f32 = train_svae.main([*argv, "--nn-precision", "highest"])
    launches = tinystep.launches
    assert launches >= 2 and tinystep.launches_bf16 == 0, \
        f"tinystep launched {launches} times in its f32 mode"
    plain = train_svae.main(["--config", "pinwheel-svae", "--steps", "50",
                             "--device", "cuda", "--engine", "plain"])
    print(f"phase 5: main path (nn_precision default: bf16 products): {launches_bf16} kernel "
          f"launches (each one cluster of {tinystep.DEFAULT_CLUSTER} CTAs), kernel "
          f"{run1['steps_per_s']:.1f} steps/s, test ELBO/pt "
          f"{run1['init_test_elbo_per_point']:.4f} -> {rows[-1]['test_elbo_per_point']:.4f}, "
          f"IW/pt {run1['final_test_iw_loglik_per_point']:.4f}; at --nn-precision highest "
          f"(f32): {launches} launches, {run_f32['steps_per_s']:.1f} steps/s, test ELBO/pt -> "
          f"{run_f32['rows'][-1]['test_elbo_per_point']:.4f}, IW/pt "
          f"{run_f32['final_test_iw_loglik_per_point']:.4f}; plain "
          f"{plain['steps_per_s']:.1f} steps/s (50 steps), runs bit-equal; {card}")

    # tinystep's bound, per step at the pinwheel shape (chunks of t_kernel):
    # the decoder MLP over S·N·K rows (backward to z) and the encoder over N
    # rows; parameters, both moments, x and the naturals once per chunk.
    from svax_torch.measure_auto import mlp_fmas

    p_tiny = n_params(state.nn_params)
    tiny_bound = bound(
        2 * (mlp_fmas([2, *cfg["hidden"], 4], cfg["s"] * n * cfg["k"], True)
             + mlp_fmas([2, *cfg["hidden"], 4], n, False)),
        4 * (6 * p_tiny + 2 * n + 3 * cfg["k"] * 9) / t_kernel + 12)

    elapsed = lambda: f"{time.perf_counter() - t_start:.0f} s"  # noqa: E731
    print(f"phases 1-5 done at {elapsed()}", flush=True)

    # 6–8. the mixtures
    mixture_kernels = mixture_phases(card)
    print(f"phases 6-8 done at {elapsed()}", flush=True)

    # A–B. auto-svae
    flex_kernel, flex_bf16_launches = auto_phases(card)
    print(f"phases A-B done at {elapsed()}", flush=True)

    # C–D. the combine kernels and mnist-svae
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    combine_kernels = combine_phase(card)
    print(f"phase C done at {elapsed()}", flush=True)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_L"
    shutil.rmtree(work, ignore_errors=True)
    (fwd_launches, bwd_launches), served = mnist_phase(card, str(work / "mnist_bundle"))
    print(f"phase D done at {elapsed()}", flush=True)
    combine_kernels[0]["launches"] = fwd_launches
    combine_kernels[1]["launches"] = bwd_launches

    # L. the training harness and the serving layer
    harness_phase(card, served, work)
    print(f"phase L done at {elapsed()}", flush=True)

    # E–F. the decoder kernels and bigk-dp
    decoder_kernels = decoder_phase(card)
    print(f"phase E done at {elapsed()}", flush=True)
    (dec_fwd, dec_bwd), bigk_ms = bigk_phase(card)
    print(f"phase F done at {elapsed()}", flush=True)
    decoder_kernels[0]["launches"] = dec_fwd
    decoder_kernels[1]["launches"] = dec_bwd

    # G. tinystep's SMM branch and the SMM paths
    smm_kernel = smm_phase(card)
    print(f"phase G done at {elapsed()}", flush=True)

    # H–I. the component-parallel kernels and the parallel paths
    rho_kernels = rho_phase(card)
    print(f"phase H done at {elapsed()}", flush=True)
    for entry, count in zip(rho_kernels, parallel_phase(card)):
        entry["launches"] = count
    print(f"phase I done at {elapsed()}", flush=True)

    # J–K. the row-sum kernels and the big-K f32 fused_decoder path
    rowsum_kernels = rowsum_phase(card)
    print(f"phase J done at {elapsed()}", flush=True)
    f32_counts, bf16_counts = fused_decoder_phase(card)
    for entry, count in zip(rowsum_kernels, (*f32_counts, *bf16_counts)):
        entry["launches"] = count
    print(f"phase K done at {elapsed()}", flush=True)

    # M. slice J: the bf16-product mode, the full head, sampled recon, serving
    bf16_kernels = bf16_steps_phase(card)
    bf16_kernels[0]["launches"] = launches_bf16
    bf16_kernels[1]["launches"] = flex_bf16_launches
    slice_j_paths_phase(card, bigk_ms)
    print(f"phase M done at {elapsed()}", flush=True)

    # N. slice H: the three-model comparison
    compare_phase(card)
    print(f"phase N done at {elapsed()}", flush=True)

    # O. slice K: the seed studies and reproduce; their launches join the line
    studies = studies_phase(card)
    print(f"phase O done at {elapsed()}", flush=True)
    bf16_kernels[0]["launches"] += studies["tinystep_bf16"]
    launches += studies["tinystep"]
    smm_kernel["launches"] += studies["tinystep_smm"]
    flex_kernel["launches"] += studies["flexstep"]
    mixture_kernels[0]["launches"] += studies["mixstep"]

    # P. slice L: the demos; their launches join the line
    demos = demos_phase(card)
    print(f"phase P done at {elapsed()}", flush=True)
    launches += demos["tinystep"]
    smm_kernel["launches"] += demos["tinystep_smm"]

    # Q. the graphed runners and the graphed evaluation against eager; the
    # evaluations' launches inside their graphs join the line
    evals = graphs_phase(card)
    print(f"phase Q done at {elapsed()}", flush=True)
    combine_kernels[0]["launches"] += evals["combine.launches"]
    decoder_kernels[0]["launches"] += evals["decoder_mlp.launches"]
    rowsum_kernels[2]["launches"] += evals["decoder.bf16_launches"]

    # 9. result
    print(json.dumps({"kernels": [{
        "name": "tinystep", "route": "cuda",
        "source": "svax_torch/ops/csrc/tinystep.cu",
        "replaces": "svax/ops/tinystep_pallas.py:621",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": tiny_bound[0],
        "bound_by": tiny_bound[1], "library_ms": None, "cluster": tinystep.DEFAULT_CLUSTER,
    }, *bf16_kernels, smm_kernel, *mixture_kernels, flex_kernel, *combine_kernels,
        *decoder_kernels, *rho_kernels, *rowsum_kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
