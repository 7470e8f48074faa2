"""Assignment log-likelihoods (``--get_pop_like``).

Reproduces reference glassy.assignLL (glassy.py:18-44) — the full ``[N, K]``
matrix in one fused device pass instead of N*K kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.models.common import DeviceCohort, pad_af_to, to_device
from wgsassign_jax.ops.loglik import (
    assign_loglik,
    assign_loglik_f64,
    assign_loglik_partitioned,
    assign_loglik_partitioned_f64,
)
from wgsassign_jax.parallel.mesh import Runtime, fetch_to_host


def assignment_loglikelihoods(
    beagle: BeagleData,
    af: np.ndarray,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    num_partitions: int = 1,
    f64_sums: bool = True,
):
    """Log-likelihood of assigning each individual to each population.

    Returns ``ll [N, K] float32``; with ``num_partitions > 1`` returns
    ``(ll, parts [N*num_partitions, K])`` where partition p sums sites with
    ``site_index % P == p`` (reference utils.partition_loglikes).

    ``f64_sums`` (default) accumulates the site-axis sums in float64 like
    the reference (glassy.py:38) via blocked f32 device partials; pass False
    for the pure-f32 single-pass reduction.
    """
    if cohort is None:
        cohort = to_device(beagle, runtime, site_multiple=num_partitions)
    rt = cohort.runtime
    af_dev = rt.shard_sites(pad_af_to(np.asarray(af, np.float32), cohort.m_pad))
    if rt.debug_checks:
        from wgsassign_jax.ops.loglik import check_loglik_inputs

        check_loglik_inputs(cohort.g0, cohort.g1, af_dev, cohort.site_weight)
    if num_partitions <= 1:
        if f64_sums:
            ll = assign_loglik_f64(cohort.g0, cohort.g1, af_dev, cohort.site_weight)
        else:
            ll = assign_loglik(cohort.g0, cohort.g1, af_dev, cohort.site_weight)
        return fetch_to_host(ll).astype(np.float32)
    if f64_sums:
        parts = assign_loglik_partitioned_f64(
            cohort.g0, cohort.g1, af_dev, cohort.site_weight, num_partitions
        )
    else:
        parts = assign_loglik_partitioned(
            cohort.g0, cohort.g1, af_dev, cohort.site_weight, num_partitions
        )  # [P, N, K]
    parts = fetch_to_host(parts)
    ll = parts.sum(axis=0).astype(np.float32)  # [N, K]
    parts = parts.astype(np.float32)
    n, k = ll.shape
    parts_nk = np.transpose(parts, (1, 0, 2)).reshape(n * num_partitions, k)
    return ll, parts_nk
