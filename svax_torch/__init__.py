"""svax_torch — the PyTorch/CUDA port of svax.

Mirrors ``svax/`` module by module (same paths, same names, same array
layouts at the public functions) so each port module can be held against
its JAX counterpart. Imports ``torch`` and numpy only; the JAX package is
the reference and is never imported here.

Ported so far: the pinwheel-SVAE training path — ``data.pinwheel``,
``expfam``, ``ops.batched_linalg``, ``pgm``, ``nets.mlp``,
``models.svae``, ``train``, the whole-train-step CUDA kernel
``ops.tinystep`` and the entry point ``svax_torch.train_svae``; and the
pure-mixture path — ``pgm.smm``, ``pgm.init``, ``models.gmm_baseline``,
``models.smm_baseline``, ``models.evaluation``, the CUDA kernels
``ops.mixstep`` (whole GMM/SMM steps) and ``ops.estep`` (the fused
E-step), and the entry points ``svax_torch.train_gmm`` and
``svax_torch.train_smm``; and the auto-svae minibatch path —
``data.auto``, ``data.load_dataset``, the ρ schedule and minibatch runner
in ``train``, ``models.evaluation.svae_iw_loglik`` and the CUDA kernel
``ops.flexstep`` (whole minibatch SVAE steps, general latent d ≤ 6),
through ``svax_torch.train_svae --config auto-svae``; and the
Student-t-prior SVAE — ``models.svae_smm``,
``models.evaluation.svae_smm_iw_loglik`` and tinystep's SMM branch,
through ``svax_torch.train_svae --smm-dof``; and data × component
parallelism — ``parallel.mesh`` (process groups on ``torch.distributed``),
``parallel.dryrun``, the sharded forms of ``pgm.gmm``, ``models.svae``,
``models.svae_smm``, ``train.svae_step`` and the baselines, the ρ-kernel
and the combine's log_norm mode in ``ops.combine``, and ``--dp`` on
``train_svae`` and ``train_gmm``; and the Bernoulli decoder's fused
x-free row sum — ``ops.decoder`` behind ``SvaeConfig.fused_decoder``,
through ``train_svae --fused-decoder``; and the training harness —
``train.trainer`` (``SvaeTrainer``, ``GmmTrainer``, ``SmmTrainer``),
``train.checkpoint``, ``train.metrics``, ``utils.guards``, the entry
``svax_torch.evaluate`` and ``models.svae.generate`` — and the serving layer,
``serve`` (bundles, the bucketed server, its ``torch.export`` tier).
``configs`` carries the named configs the entries read.
"""

__version__ = "0.1.0"
