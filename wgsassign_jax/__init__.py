"""wgsassign_jax: a population-assignment engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the
WGSassign reference (population assignment from genotype likelihoods):

- per-population allele-frequency estimation by EM  (``models.reference_af``)
- assignment log-likelihoods                         (``models.assign``)
- leave-one-out cross-validation                     (``models.loo``)
- Fisher-information effective sample sizes          (``models.ne``)
- assignment z-scores from allele depths             (``models.zscore``)
- mixture-proportion estimation (EM / MCMC)          (``models.mixture``)

Design: the genotype-likelihood tensor lives on device as ``[M_sites, N_inds, 2]``
float32 (GL of genotype 2 is reconstructed in-register as ``1 - g0 - g1``),
sharded over the SNP axis across a 1-D device mesh.  Per-population loops in
the reference become batched matmuls against a one-hot membership matrix, so
the EM update and all reductions are batched device work; cross-device merges are
tiny ``psum`` collectives.
"""

from wgsassign_jax.version import __version__

__all__ = ["__version__"]
