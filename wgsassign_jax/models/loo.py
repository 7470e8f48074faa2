"""Leave-one-out cross-validated assignment (``--loo``).

Reference semantics (glassy.loo, glassy.py:47-112): for each individual i,
re-estimate its own population's AF with i left out (a full EM re-run),
clamp, write it into the shared AF matrix **in place**, then evaluate i's
log-likelihood to all K populations.  Because of the in-place write, the AF
column used for a *foreign* population j is the LOO AF of the most recently
processed member of j (the last j-member with index <= i), falling back to
the full-data AF when no j-member precedes i — an order-dependent quirk this
implementation reproduces exactly (see SURVEY §2.5), batched:

  * all N LOO EM problems run as K batched device computations (one per
    population, ``em_maf_loo_group``), not N serial EM re-runs;
  * the quirky AF selection becomes a static ``[N, K]`` row-index table —
    and because column j of that table only ever references population
    j's LOO rows (or the full-data column j), LL column j is evaluated
    right after population j's EM against a ``[n_p + 1, M]`` mini-bank,
    so no ``[N + K, M]`` AF bank ever materializes;
  * each column's N log-likelihood sums run as one scanned device pass.

The whole pipeline is device-resident: member panels are ``[n_p, M]``
gathers of the uploaded cohort, and the only host↔device traffic is the
small ``[K, M]`` full-data AF upload and the ``[N]``-per-population result
downloads.

``compat_af_mutation=False`` gives the statistically clean variant instead:
foreign-population likelihoods always use the full-data AF.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.io.ids import PopulationMap
from wgsassign_jax.models.common import DeviceCohort, to_device
from wgsassign_jax.ops.emmaf import em_maf_loo_group
from wgsassign_jax.ops.loglik import (
    assign_loglik_selected,
    assign_loglik_selected_f64,
    assign_loglik_selected_partitioned,
    assign_loglik_selected_partitioned_f64,
)
from wgsassign_jax.parallel.mesh import PAD_AF, Runtime, fetch_to_host


@dataclass
class LooResult:
    ll: np.ndarray         # float32 [N, K]
    parts: np.ndarray      # float32 [N * num_partitions, K] (partition sums)
    iters: np.ndarray      # int32 [N] per-individual LOO EM convergence iteration
    converged: np.ndarray  # bool [N]


def loo_af_column_index(popmap: PopulationMap, compat_af_mutation: bool) -> np.ndarray:
    """Abstract AF row selection ``[loo_0..loo_{N-1}, full_0..full_{K-1}]``
    used for pair (individual i, population j).  Column j only ever selects
    population j's LOO rows or the full-data sentinel ``n + j`` — the
    property ``leave_one_out`` exploits to evaluate each column against a
    per-population mini-bank (``searchsorted`` remaps the values)."""
    n, k = popmap.n_inds, popmap.n_pops
    col_idx = np.empty((n, k), dtype=np.int32)
    all_inds = np.arange(n)
    for j in range(k):
        members = popmap.members_of(popmap.pops[j])
        if compat_af_mutation:
            # last member of pop j with index <= i (for i in pop j this is i
            # itself); fall back to the full-data column when none precedes.
            pos = np.searchsorted(members, all_inds, side="right") - 1
            col = np.where(pos >= 0, members[np.clip(pos, 0, None)], n + j)
        else:
            # clean mode: own pop -> own LOO column; foreign -> full-data AF.
            col = np.full(n, n + j, dtype=np.int64)
            col[members] = members
        col_idx[:, j] = col
    return col_idx


def leave_one_out(
    beagle: BeagleData,
    af_full: np.ndarray,
    popmap: PopulationMap,
    max_iter: int = 200,
    tol: float = 1e-4,
    downsampled: Optional[BeagleData] = None,
    num_partitions: int = 1,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    downsampled_cohort: Optional[DeviceCohort] = None,
    compat_af_mutation: bool = True,
    verbose: bool = False,
    f64_sums: bool = True,
    checkpoint_path: Optional[str] = None,
) -> LooResult:
    """``checkpoint_path`` records each population's finished LOO EM, so an
    interrupted run resumes at population granularity."""
    if cohort is None:
        cohort = to_device(beagle, runtime, site_multiple=num_partitions)
    rt = cohort.runtime
    n = cohort.n_inds
    m_pad = cohort.m_pad
    m_real = cohort.m_real

    sizes = popmap.pop_sizes
    if np.any(sizes < 2):
        bad = popmap.pops[sizes < 2]
        raise ValueError(
            f"Leave-one-out requires >= 2 individuals per population; too small: {bad}"
        )

    # --- source cohort for the likelihood pass (optionally downsampled) ----
    if downsampled_cohort is not None:  # prebuilt (e.g. streamed ingest)
        src = downsampled_cohort
    elif downsampled is not None:
        src = to_device(downsampled, rt, site_multiple=num_partitions)
    else:
        src = cohort
    if src is not cohort and (
        src.m_pad != cohort.m_pad or src.m_real != cohort.m_real
    ):
        raise ValueError(
            "Downsampled Beagle must cover the same sites as the reference "
            "after intersection"
        )

    # --- batched LOO EM + per-population likelihood columns ----------------
    # With the in-place-AF quirk expressed as an index table, LL column j
    # depends only on population j's LOO AF rows plus the full-data column
    # j, so each population's likelihood column is evaluated right after
    # its EM against a small [n_p + 1, M] mini-bank.
    k = popmap.n_pops
    af_t_h = np.full((k, m_pad), PAD_AF, dtype=np.float32)
    af_t_h[:, :m_real] = np.asarray(af_full, np.float32).T
    af_t = _shard_rows(rt, af_t_h)  # [K, M] — the only (small) H2D here
    if rt.debug_checks:
        from wgsassign_jax.ops.loglik import check_loglik_inputs

        check_loglik_inputs(
            cohort.g0, cohort.g1, af_t.T, cohort.site_weight
        )
    col_idx_global = loo_af_column_index(popmap, compat_af_mutation)
    iters = np.empty(n, dtype=np.int32)
    converged = np.empty(n, dtype=bool)
    p_count = max(num_partitions, 1)
    ll = np.empty((n, k), dtype=np.float64)
    parts_nk = np.empty((n, p_count, k), dtype=np.float64)
    for j, pop in enumerate(popmap.pops):
        members = popmap.members_of(pop)
        members_d = rt.replicate(members)
        done_path = (f"{checkpoint_path}.pop{j}.done.npz"
                     if checkpoint_path else None)
        if done_path and os.path.exists(done_path):
            # per-population restart point: this population's LOO EM already
            # finished in an interrupted earlier run
            with np.load(done_path) as z:
                f_h = np.full((len(members), m_pad), PAD_AF, np.float32)
                f_h[:, :m_real] = z["f"]
                it_p, conv_p = z["iters"], z["converged"]
            f_p = _shard_rows(rt, f_h)
        else:
            f_p, it_p, conv_p = _loo_group_em(
                cohort, members_d, m_real, max_iter, tol
            )
            if done_path:
                _save_pop_done(done_path, f_p, it_p, conv_p, m_real)
        n_loo = sizes[j] - 1
        min_val = np.float32(1.0 / (2.0 * (n_loo + 1.0)))
        # mini-bank for LL column j: this population's clamped LOO rows
        # plus the full-data column (row n_p) for individuals no j-member
        # precedes
        mini_bank = _mini_bank(f_p, af_t, j, min_val)
        # map the global AF row selection to mini-bank rows: member index
        # -> its position; the full-data sentinel (n + j) sorts past every
        # member and lands on row n_p
        col_j = np.searchsorted(
            members, col_idx_global[:, j]
        ).astype(np.int32).reshape(n, 1)
        col_j_d = rt.replicate(col_j)
        if num_partitions <= 1:
            if f64_sums:
                ll_j = assign_loglik_selected_f64(
                    src.g0, src.g1, mini_bank, col_j_d, src.site_weight
                )
            else:
                ll_j = fetch_to_host(assign_loglik_selected(
                    src.g0, src.g1, mini_bank, col_j_d, src.site_weight
                ))
            ll[:, j] = np.asarray(ll_j)[:, 0]
            parts_nk[:, 0, j] = ll[:, j]
        else:
            if f64_sums:
                ll_j, parts_j = assign_loglik_selected_partitioned_f64(
                    src.g0, src.g1, mini_bank, col_j_d, src.site_weight,
                    num_partitions,
                )
            else:
                ll_jd, parts_jd = assign_loglik_selected_partitioned(
                    src.g0, src.g1, mini_bank, col_j_d, src.site_weight,
                    num_partitions,
                )
                ll_j = fetch_to_host(ll_jd)
                parts_j = fetch_to_host(parts_jd)
            ll[:, j] = np.asarray(ll_j)[:, 0]
            parts_nk[:, :, j] = np.asarray(parts_j)[:, :, 0]
        iters[members] = fetch_to_host(it_p)
        converged[members] = fetch_to_host(conv_p)
        if verbose:
            print(f"LOO EM for population {pop}: {len(members)} problems, "
                  f"iterations {iters[members].min()}..{iters[members].max()}")
    if checkpoint_path:
        # LOO finished: drop the per-population restart files
        for j in range(k):
            try:
                os.remove(f"{checkpoint_path}.pop{j}.done.npz")
            except FileNotFoundError:
                pass  # absent, or another process on a shared filesystem won

    return LooResult(
        ll=ll.astype(np.float32),
        parts=parts_nk.astype(np.float32).reshape(n * p_count, k),
        iters=iters,
        converged=converged,
    )


@jax.jit
def _mini_bank(f_p, af_t, j, min_val):
    """``[n_p + 1, M]`` likelihood bank for one population: its clamped LOO
    AF rows followed by the full-data AF column ``j``."""
    full_row = jax.lax.dynamic_slice_in_dim(af_t, j, 1, axis=0)
    return jnp.concatenate(
        [jnp.clip(f_p, min_val, 1.0 - min_val), full_row], axis=0
    )


def _loo_group_em(cohort, members_d, m_real, max_iter, tol):
    """One population's batched LOO EM: ``(f [n_p, M] device, iters,
    converged)``."""
    g0p, g1p = _member_panels(cohort.g0, cohort.g1, members_d)
    return em_maf_loo_group(
        g0p, g1p, cohort.site_weight, m_real, max_iter, tol
    )


def _save_pop_done(path, f_p, it_p, conv_p, m_real):
    """Atomically record one population's finished LOO EM (real sites only)
    so an interrupted run resumes at population granularity."""
    from wgsassign_jax.obs.checkpoint import save_npz_atomic
    from wgsassign_jax.parallel.mesh import is_primary

    f_h = fetch_to_host(f_p)[:, :m_real]
    if not is_primary():
        return  # one writer per shared filesystem
    save_npz_atomic(
        path,
        f=np.asarray(f_h, np.float32),
        iters=np.asarray(it_p, np.int32),
        converged=np.asarray(conv_p, bool),
    )


@jax.jit
def _member_panels(g0, g1, members):
    """Transposed device-side gather of one population's member columns:
    ``[M, N] -> [n_p, M]``.  Padded cohort rows already hold the
    (PAD_G0, PAD_G1) GL pattern the LOO EM pins to its fixed point."""
    return jnp.take(g0, members, axis=1).T, jnp.take(g1, members, axis=1).T


def _shard_rows(rt: Runtime, arr: np.ndarray):
    """Device-put a ``[rows, M]`` array sharded along its site (second)
    axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wgsassign_jax.parallel.mesh import SNP_AXIS

    return jax.device_put(arr, NamedSharding(rt.mesh, P(None, SNP_AXIS)))
