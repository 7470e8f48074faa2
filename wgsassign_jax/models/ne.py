"""Fisher-information effective sample sizes (``--ne_obs``).

Reproduces reference fisher.fisher_obs / fisher_obs_ind (fisher.py:11-59)
as one batched device computation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.io.ids import PopulationMap
from wgsassign_jax.models.common import DeviceCohort, pad_af_to, to_device
from wgsassign_jax.ops.fisher import fisher_obs_pops
from wgsassign_jax.parallel.mesh import Runtime, fetch_to_host


@dataclass
class NeResult:
    f_obs: np.ndarray   # float32 [M, K] observed Fisher information
    ne_obs: np.ndarray  # float32 [M, K] per-site effective sample size
    ne_ind: np.ndarray  # float32 [N] per-individual Ne (mean over sites)


# Site-block size cap: the Fisher op materializes an [M_block, N] term
# temporary for the membership matmul, so large cohorts stream in blocks
# (pointwise over sites — block boundaries change nothing numerically
# except the ne_ind partial-sum association, handled below).  Set for a
# 16 GB device; it fits the H100's 80 GB but has not been measured there.
_BLOCK_TEMP_BYTES = 512 * 1024 * 1024


def effective_sample_sizes(
    beagle: BeagleData,
    af: np.ndarray,
    popmap: PopulationMap,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    site_block: Optional[int] = None,
) -> NeResult:
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    m_pad, n = cohort.m_pad, cohort.n_inds
    if site_block is None:
        site_block = max(_BLOCK_TEMP_BYTES // (4 * n), 1)
    mult = rt.site_multiple()
    site_block = max(site_block // mult, 1) * mult

    af_h = pad_af_to(np.asarray(af, np.float32), m_pad)
    membership = rt.replicate(popmap.membership)
    pop_index = rt.replicate(popmap.pop_index)

    if site_block >= m_pad:
        blocks = [(0, m_pad)]
    else:
        blocks = [
            (lo, min(lo + site_block, m_pad))
            for lo in range(0, m_pad, site_block)
        ]
    m = cohort.m_real
    f_obs = np.empty((m, popmap.n_pops), dtype=np.float32)
    ne_obs = np.empty((m, popmap.n_pops), dtype=np.float32)
    ne_ind_sum = np.zeros(n, dtype=np.float64)
    for lo, hi in blocks:
        fo, no, ni = fisher_obs_pops(
            cohort.g0[lo:hi],
            cohort.g1[lo:hi],
            rt.shard_sites(af_h[lo:hi]),
            membership,
            pop_index,
            cohort.site_weight[lo:hi],
            1.0,  # per-block sums; the mean is taken below over m_real
        )
        real_hi = min(hi, m)
        fo_h, no_h = fetch_to_host(fo), fetch_to_host(no)
        if real_hi > lo:
            f_obs[lo:real_hi] = fo_h[: real_hi - lo]
            ne_obs[lo:real_hi] = no_h[: real_hi - lo]
        ne_ind_sum += fetch_to_host(ni).astype(np.float64)
    ne_ind = (ne_ind_sum / m).astype(np.float32)
    return NeResult(f_obs=f_obs, ne_obs=ne_obs, ne_ind=ne_ind)
