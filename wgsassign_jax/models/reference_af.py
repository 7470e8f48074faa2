"""Reference-population allele-frequency estimation (``--get_reference_af``).

Reproduces the reference driver block WGSassign.py:205-249: per-population
MAF EM (emMAF.py:15-27) followed by clamping to ``[1/(2(n+1)), 1-1/(2(n+1))]``
(WGSassign.py:236-240).  Unlike the reference's serial per-pop loop, all K
populations run as one batched device computation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.io.ids import PopulationMap
from wgsassign_jax.models.common import DeviceCohort, to_device
from wgsassign_jax.ops.emmaf import clamp_af, em_maf_pops
from wgsassign_jax.parallel.mesh import Runtime, fetch_to_host


@dataclass
class ReferenceAFResult:
    af: np.ndarray          # float32 [M, K], clamped
    pops: np.ndarray        # [K] population names (sorted unique order)
    iters: np.ndarray       # int32 [K] 1-based EM convergence iteration
    converged: np.ndarray   # bool [K]


def estimate_reference_af(
    beagle: BeagleData,
    popmap: PopulationMap,
    max_iter: int = 200,
    tol: float = 1e-4,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
) -> ReferenceAFResult:
    if cohort is None:
        cohort = to_device(beagle, runtime)
    if cohort.n_inds != popmap.n_inds:
        raise ValueError(
            "Number of individuals in beagle and reference ID file do not match!"
        )
    rt = cohort.runtime
    f, iters, converged = em_maf_pops(
        cohort.g0,
        cohort.g1,
        rt.replicate(popmap.membership),
        rt.replicate(popmap.pop_index),
        cohort.site_weight,
        cohort.m_real,
        max_iter,
        tol,
    )
    f = clamp_af(f, popmap.pop_sizes)
    return ReferenceAFResult(
        af=fetch_to_host(f)[: cohort.m_real].astype(np.float32),
        pops=popmap.pops,
        iters=np.asarray(iters),
        converged=np.asarray(converged),
    )
