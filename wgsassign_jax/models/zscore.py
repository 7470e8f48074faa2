"""Assignment z-scores (``--get_reference_z_score`` / ``--get_assignment_z_score``).

Pipeline per individual i (reference WGSassign.py:346-384, 425-446 and
zscore.py — see SURVEY §2.8 for the full semantics):

1. Group sites by the individual's allele-depth combo (Ar, Aa); per combo
   record the count and mean GL triple.                 [host, vectorized]
2. Filter combos: ``single_read`` keeps total-depth-1 combos; otherwise
   count > threshold and depth != 0; then keep only depths D whose combo
   count exceeds D (all D+1 splits observed).           [host]
3. Keep sites whose combo survived and whose GL at the combo-mean's argmax
   entry is within 0.01 of that mean.                   [host, vectorized]
4. AF at kept sites: reference mode re-runs the LOO EM for i's population
   restricted to kept sites; assignment mode slices the saved AF panel at
   the individual's *assigned* population.              [device]
5. Binomial read-probability tables with error rate e=0.01; expected /
   variance W sums; Z = (W_obs - mu) / sqrt(var).       [device kernel]

The reference's per-site Python dict loops (zscore.py:11-61 — its admitted
bottleneck) become np.unique/bincount passes; the per-site split loops
become the ``zscore_sums`` gather kernel.  Shapes are bucketed so the number
of distinct compilations stays small across individuals.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.io.ids import PopulationMap
from wgsassign_jax.models.common import DeviceCohort, to_device
from wgsassign_jax.ops.emmaf import em_maf_sites_batch
from wgsassign_jax.ops.zscore_ops import zscore_sums_batch_compact
from wgsassign_jax.parallel.mesh import PAD_AF, PAD_G0, PAD_G1, Runtime

F32 = np.float32

SEQ_ERROR_RATE = 0.01       # hard-coded in the reference (WGSassign.py:350,430)
GL_MEAN_TOLERANCE = 0.01    # hard-coded in the reference (zscore.py:55)

# Device-memory budget for one batched z-score block (gathered member
# panels + split tables).  Bounds B, the number of individuals whose
# z pipelines run as a single device computation.  Set for a 16 GB device;
# it fits the H100's 80 GB but has not been measured there.
Z_BLOCK_BYTES = 2 << 30

# Device-memory budget for one AF/EM group: the number of individuals
# whose kept-site AF panels (and, reference mode, batched LOO EMs) are
# produced by a single af_block_fn call.  Per individual this is a few
# [1, s_pad] float32 rows (EM state, weights, AF), so the group spans
# many z-sums blocks — decoupling it from Z_BLOCK_BYTES is what keeps
# the per-block EM drives (and their per-chunk host syncs) from
# multiplying at large site counts.  AF_GROUP_MAX_INDS caps the group
# against estimate error: the group's AF panel stays resident through
# all of its z-sums blocks.  Like Z_BLOCK_BYTES, not measured on the H100.
AF_GROUP_BYTES = 1 << 30
AF_GROUP_MAX_INDS = 64


@dataclass
class ComboTables:
    """Per-individual combo grouping + site filter result."""

    combos: np.ndarray      # int64 [R, 2] kept (Ar, Aa) combos
    mean_gl: np.ndarray     # float32 [R, 3] mean GL triple per combo
    read_probs: np.ndarray  # float32 [R, 3] P(reads | genotype)
    keep_sites: np.ndarray  # int64 [S] kept site indices (ascending)
    site_row: np.ndarray    # int32 [S] combo row per kept site
    site_depth: np.ndarray  # int64 [S] total depth per kept site
    g0_keep: np.ndarray     # float32 [S] the individual's GL(g=0) at kept sites
    g1_keep: np.ndarray     # float32 [S] the individual's GL(g=1) at kept sites


class FilteringError(ValueError):
    pass


def build_combo_tables(
    gl_i: np.ndarray,
    ad_i: np.ndarray,
    n_threshold: int,
    single_read_threshold: bool,
    e: float = SEQ_ERROR_RATE,
) -> ComboTables:
    """Steps 1-3 + the read-probability table, vectorized on host.

    Args:
      gl_i: float32 ``[M, 2]`` — (g0, g1) of the individual.
      ad_i: int ``[M, 2]`` — (major, minor) read counts of the individual.
    """
    g0 = gl_i[:, 0].astype(F32)
    g1 = gl_i[:, 1].astype(F32)
    g2 = (1.0 - g0 - g1).astype(F32)
    ar = ad_i[:, 0].astype(np.int64)
    aa = ad_i[:, 1].astype(np.int64)
    width = int(aa.max()) + 1 if aa.size else 1
    code = ar * width + aa
    uniq, inv, counts = np.unique(code, return_inverse=True, return_counts=True)
    r_all = len(uniq)
    mean_gl = np.zeros((r_all, 3), dtype=np.float64)
    for gi, g in enumerate((g0, g1, g2)):
        mean_gl[:, gi] = np.bincount(inv, weights=g.astype(np.float64), minlength=r_all)
    mean_gl /= counts[:, None]
    combos = np.stack([uniq // width, uniq % width], axis=1)
    totals = combos.sum(axis=1)

    if single_read_threshold:
        keep = totals == 1
    else:
        keep = (counts > n_threshold) & (totals != 0)
    if keep.sum() < 2:
        raise FilteringError(
            "Not enough allele-count combinations were kept! Too stringent filtering?"
        )
    # keep only depths where all D+1 splits were observed among kept combos
    kept_tot = totals[keep]
    dl, dl_counts = np.unique(kept_tot, return_counts=True)
    dl_keep = dl[dl < dl_counts]
    keep &= np.isin(totals, dl_keep)
    if keep.sum() == 0:
        raise FilteringError(
            "No complete depth classes survived filtering (no depth has all "
            "of its allele-count splits observed)"
        )

    # site filter: combo kept AND |GL - comboMean| <= tol at the mean's argmax
    site_combo_kept = keep[inv]
    max_id = mean_gl.argmax(axis=1)
    gl3 = np.stack([g0, g1, g2], axis=1).astype(np.float64)
    site_val = gl3[np.arange(len(inv)), max_id[inv]]
    mean_val = mean_gl[inv, max_id[inv]]
    site_ok = np.abs(mean_val - site_val) <= GL_MEAN_TOLERANCE
    keep_sites = np.flatnonzero(site_combo_kept & site_ok)
    if keep_sites.size == 0:
        raise FilteringError("No loci were kept! Too stringent filtering?")

    # compact row numbering over kept combos only
    old_rows = np.flatnonzero(keep)
    new_row_of = -np.ones(r_all, dtype=np.int32)
    new_row_of[old_rows] = np.arange(len(old_rows), dtype=np.int32)
    site_row = new_row_of[inv[keep_sites]]

    kept_combos = combos[old_rows]
    read_probs = np.zeros((len(old_rows), 3), dtype=F32)
    for r, (car, caa) in enumerate(kept_combos):
        d = int(car + caa)
        c = math.factorial(d) / (math.factorial(int(caa)) * math.factorial(int(car)))
        read_probs[r, 0] = c * ((1.0 - e) ** car) * (e**caa)
        read_probs[r, 1] = c * (0.5**d)
        read_probs[r, 2] = c * ((1.0 - e) ** caa) * (e**car)

    return ComboTables(
        combos=kept_combos,
        mean_gl=mean_gl[old_rows].astype(F32),
        read_probs=read_probs,
        keep_sites=keep_sites,
        site_row=site_row,
        site_depth=totals[inv[keep_sites]],
        g0_keep=np.ascontiguousarray(g0[keep_sites]),
        g1_keep=np.ascontiguousarray(g1[keep_sites]),
    )


def _bucket(n: int, mult: int) -> int:
    """Round up to a multiple of ``mult``, then to 'few distinct sizes'
    granularity (next power-of-two-ish) to bound recompilation."""
    n = max(n, 1)
    size = 1 << (n - 1).bit_length()
    return -(-max(size, mult) // mult) * mult


def _split_tables(tables: ComboTables) -> np.ndarray:
    """Per-depth split enumeration ``rows_by_depth [D_max+1, C]``: the
    combo-table row of split ``(d-x, x)`` for each kept depth ``d``.  All
    splits exist by the depth-class filter; the validity mask is just
    ``x <= d``, derived on device.  The per-SITE ``[S, C]`` expansion also
    happens on device (`zscore_sums_batch_compact`) — shipping it from the
    host cost ~8·C bytes/site."""
    row_of = {
        (int(a), int(b)): r for r, (a, b) in enumerate(tables.combos)
    }
    depths = np.unique(tables.site_depth)
    c_max = int(depths.max()) + 1
    rows_by_depth = np.zeros((c_max, c_max), dtype=np.int32)
    for d in depths:
        for x in range(int(d) + 1):
            rows_by_depth[d, x] = row_of[(int(d - x), int(x))]
    return rows_by_depth


@dataclass
class ZScoreResult:
    z: np.ndarray           # float32 [n_sub]
    loci: np.ndarray        # int32 [n_sub] kept-site counts
    w_obs: np.ndarray       # float32 [n_sub]
    w_mu: np.ndarray        # float32 [n_sub]
    w_var: np.ndarray       # float32 [n_sub]


@dataclass
class _ZBlock:
    """Host-assembled batched operands for one block of B individuals.

    All per-individual combo tables are padded to shapes shared across the
    whole ``[ind_start, ind_end)`` range, so every block of the run reuses
    one compiled program (the final partial block is padded with repeats of
    its last individual; repeated results are discarded).

    Deliberately COMPACT: the per-site GLs, site weights, split tables and
    AF values are all derived on device from ``keep``/``depth``/``s_real``
    and the (tiny) combo tables — host→device traffic per block is two
    ``[B, S]`` int32 panels instead of the ~(3 + 2·C) float panels a naive
    assembly ships."""

    inds: List[int]          # real individual index per slot (repeats pad)
    n_real: int              # number of non-repeated leading slots
    keep: np.ndarray         # int32 [B, S] kept-site indices (pad -> 0)
    s_real: np.ndarray       # float32 [B] kept-site counts
    depth: np.ndarray        # int32 [B, S] total depth per kept site (pad 0)
    rows_by_depth: np.ndarray  # int32 [B, C, C] combo row of split x at depth d
    like_tab: np.ndarray     # float32 [B, R, 3]
    fact_tab: np.ndarray     # float32 [B, R, 3]

    @functools.cached_property
    def weight(self) -> np.ndarray:
        """float32 [B, S] — 1.0 on the first ``s_real`` kept-site slots
        (host copy, computed once per block; the device pipeline derives
        it from ``s_real``)."""
        s_pad = self.keep.shape[1]
        return (
            np.arange(s_pad)[None, :] < self.s_real[:, None]
        ).astype(F32)


def _pad_to(a: np.ndarray, value, shape) -> np.ndarray:
    out = np.full(shape, value, dtype=a.dtype)
    out[tuple(slice(0, d) for d in a.shape)] = a
    return out


def _gather_block_inputs(rt: Runtime, cohort, keep, inds, s_real):
    """Device-derived per-site z operands: the individuals' GLs at their
    kept sites (a ``[B, S]`` cohort gather) and the kept-slot weight mask
    (from ``s_real``) — replacing three host-built-and-uploaded float
    panels."""
    def body(g0, g1, k, idx, sr):
        g0k = g0[k, idx[:, None]]
        g1k = g1[k, idx[:, None]]
        w = (
            jnp.arange(k.shape[1])[None, :] < sr[:, None]
        ).astype(jnp.float32)
        return g0k, g1k, w

    fn = _z_sharded_jit(rt, "gather_block_inputs", body, True)
    put = rt.replicate if rt.n_devices > 1 else jnp.asarray
    return fn(cohort.g0, cohort.g1, put(keep), put(inds),
              put(np.asarray(s_real, F32)))


def _gather_af_block(rt: Runtime, af_dev, keep, cols):
    """Assignment-mode AF at kept sites: ``[M, K] -> [B, S]`` device
    gather (the AF panel uploads once per run, not per block)."""
    def body(afp, k, c):
        return afp[k, c[:, None]]

    fn = _z_sharded_jit(rt, "gather_af_block", body, True)
    put = rt.replicate if rt.n_devices > 1 else jnp.asarray
    return fn(af_dev, put(keep), put(cols))


@jax.jit
def _gather_gl_columns(g0, g1, idx):
    """Device-side gather of a chunk of individuals' GL columns:
    ``[M, N] x2 -> [M, B, 2]``.  On a multi-host mesh GSPMD keeps the
    gather shard-local (the site axis is the sharded one)."""
    return jnp.stack(
        [jnp.take(g0, idx, axis=1), jnp.take(g1, idx, axis=1)], axis=-1
    )


def _gl_column_iter(beagle, cohort, inds, chunk: Optional[int] = None):
    """Yield ``(i, gl_i [M_real, 2])`` per individual.

    Host fast path when the full parse is resident (single-host
    :class:`BeagleData`); otherwise the columns are gathered from the
    device cohort in chunks — this is what lets the z pipeline run on
    multi-host row-sharded ingest and on ``--stream_ingest`` cohorts whose
    GL matrix never exists on the host."""
    if isinstance(beagle, BeagleData):
        for i in inds:
            yield i, beagle.gl[:, i, :]
        return
    from wgsassign_jax.parallel.mesh import fetch_to_host

    m_real = cohort.m_real
    if chunk is None:
        # ~256 MB of gathered columns per fetch, at least 1 individual
        chunk = max(1, (1 << 28) // (8 * max(m_real, 1)))
    for lo in range(0, len(inds), chunk):
        block = list(inds[lo : lo + chunk])
        cols = _gather_gl_columns(
            cohort.g0, cohort.g1,
            jnp.asarray(np.asarray(block, np.int32)),
        )
        cols_h = fetch_to_host(cols)[:m_real]  # [M_real, B, 2]
        for bi, i in enumerate(block):
            yield i, cols_h[:, bi, :]


def _prepare_tables(beagle, cohort, ad, inds, n_threshold,
                    single_read_threshold, error_rate=SEQ_ERROR_RATE):
    """Combo tables + split enumerations for every individual in the range
    (vectorized host passes), and the shared padded shapes.

    Individuals build CONCURRENTLY on a host thread pool — the sort/
    bincount passes release the GIL, so this serial host stage (flagged
    at full cohort width) scales with host cores;
    a bounded in-flight window keeps peak memory at O(workers) GL
    columns, not O(N).  Failures surface in individual order, matching
    the serial path."""
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    tables, splits = {}, {}

    def build(i, gl_i):
        t = build_combo_tables(
            gl_i, ad[:, 2 * i : 2 * i + 2],
            n_threshold, single_read_threshold, e=error_rate,
        )
        return i, t, _split_tables(t)

    workers = min(max(os.cpu_count() or 1, 1), 8)

    def drain(fut):
        i, t, sp = fut.result()
        tables[i] = t
        splits[i] = sp

    pending = deque()
    with ThreadPoolExecutor(workers) as pool:
        for i, gl_i in _gl_column_iter(beagle, cohort, inds):
            pending.append(pool.submit(build, i, gl_i))
            while len(pending) > 2 * workers:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
    s_max = max(t.keep_sites.size for t in tables.values())
    c_max = max(r.shape[1] for r in splits.values())
    r_max = max(len(t.combos) for t in tables.values())
    return tables, splits, s_max, c_max, r_max


def _assemble_block(tables, splits, inds, b_pad, s_pad, c_pad, r_pad):
    n_real = len(inds)
    slots = list(inds) + [inds[-1]] * (b_pad - n_real)
    keep = np.zeros((b_pad, s_pad), dtype=np.int32)
    s_real = np.zeros((b_pad,), dtype=F32)
    depth = np.zeros((b_pad, s_pad), dtype=np.int32)
    rows_by_depth = np.zeros((b_pad, c_pad, c_pad), dtype=np.int32)
    # padded combo rows carry a harmless valid triple; they are never
    # gathered (rows_by_depth only references real rows) but stay finite.
    like_tab = np.zeros((b_pad, r_pad, 3), dtype=F32)
    like_tab[:, :, 0] = 1.0
    fact_tab = np.zeros((b_pad, r_pad, 3), dtype=F32)
    for slot, i in enumerate(slots):
        t = tables[i]
        s = t.keep_sites.size
        keep[slot, :s] = t.keep_sites
        s_real[slot] = s
        depth[slot, :s] = t.site_depth
        rbd = splits[i]
        rows_by_depth[slot, : rbd.shape[0], : rbd.shape[1]] = rbd
        like_tab[slot, : len(t.combos)] = t.mean_gl
        fact_tab[slot, : len(t.combos)] = t.read_probs
    return _ZBlock(
        inds=slots, n_real=n_real, keep=keep, s_real=s_real, depth=depth,
        rows_by_depth=rows_by_depth, like_tab=like_tab, fact_tab=fact_tab,
    )


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _loo_af_block(g0, g1, keep, mem, mem_mask, site_w, s_real, max_iter, tol):
    """Per-problem leave-one-out AF at each individual's kept sites: one
    gather + one batched EM for the whole block (the reference re-runs a
    full serial EM per individual, WGSassign.py:352-364)."""
    g0p = g0[keep[:, None, :], mem[:, :, None]]  # [B, P, S]
    g1p = g1[keep[:, None, :], mem[:, :, None]]
    f, _, _ = em_maf_sites_batch(
        g0p, g1p, mem_mask, site_w, s_real, max_iter, tol
    )
    return _clamp_loo_af(f, mem_mask)


# --- LOO-structured reference-mode EM helpers ------------------------------
# The shard-local reformulation: per population, the member
# panel is a shard-local column take of the cohort shared by all of its
# problems, the EM runs over the full site axis with kept-site masks only
# in the convergence partials (per-site independence makes the kept-site
# trajectories identical), and only the final [B, S] kept-value gather
# crosses shards — P-times less data motion than gathering [B, P, S]
# panels.  The gathered path does less compute under strong filtering on
# one device.  See ops/emmaf.py::em_maf_loo_subset.

_Z_JIT_CACHE = {}


def _z_sharded_jit(rt: Runtime, name: str, body, out_axis1_sharded: bool):
    """Cache one compiled program per (mesh, helper); multi-device outputs
    are pinned sharded on their site axis."""
    sharding = None
    if rt.n_devices > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from wgsassign_jax.parallel.mesh import SNP_AXIS

        spec = P(None, SNP_AXIS) if out_axis1_sharded else P()
        sharding = NamedSharding(rt.mesh, spec)
    key = (name, rt.mesh if rt.n_devices > 1 else None)
    fn = _Z_JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(body, out_shardings=sharding)
        _Z_JIT_CACHE[key] = fn
    return fn


def _scatter_site_weight(rt: Runtime, keep, weight, m_pad: int):
    """Device-side ``[G, m_pad]`` kept-site mask from kept-site indices
    (padded slots carry index 0 with weight 0 — the .add is a no-op)."""
    def body(k, w):
        g = k.shape[0]
        out = jnp.zeros((g, m_pad), jnp.float32)
        return out.at[jnp.arange(g)[:, None], k].add(w)

    fn = _z_sharded_jit(rt, f"scatter_w_{m_pad}", body, True)
    put = rt.replicate if rt.n_devices > 1 else jnp.asarray
    return fn(put(keep), put(weight))


def _gather_kept_af(rt: Runtime, f, keep, min_val):
    """Clamped AF at each problem's kept sites: ``[G, M] -> [G, S]``."""
    def body(fv, k, mv):
        return jnp.clip(jnp.take_along_axis(fv, k, axis=1), mv, 1.0 - mv)

    fn = _z_sharded_jit(rt, "gather_kept_af", body, True)
    put = rt.replicate if rt.n_devices > 1 else jnp.asarray
    return fn(f, put(keep), jnp.float32(min_val))


@jax.jit
def _reorder_concat(idx, *parts):
    """Stack per-population result rows back into block slot order."""
    return jnp.concatenate(parts, axis=0)[idx]


@jax.jit
def _member_panels_t(g0, g1, members):
    """Shard-local transposed member-column take: ``[M, N] -> [n_p, M]``."""
    return jnp.take(g0, members, axis=1).T, jnp.take(g1, members, axis=1).T


@jax.jit
def _clamp_loo_af(f, mem_mask):
    counts = jnp.sum(mem_mask, axis=1)
    # reference clamp with n = LOO member count (WGSassign.py:358-364)
    min_val = 1.0 / (2.0 * (counts + 1.0))
    return jnp.clip(f, min_val[:, None], 1.0 - min_val[:, None])


def _run_blocks(
    cohort, beagle, ad, ind_start, ind_end, af_block_fn, per_ind_bytes_extra,
    n_threshold, single_read_threshold, verbose, block_bytes=None,
    error_rate=SEQ_ERROR_RATE,
):
    """Shared batched driver.  ``af_block_fn(block)`` returns a
    device ``[B, S]`` AF panel for the block's kept sites."""
    rt = cohort.runtime
    inds = list(range(ind_start, ind_end))
    out = _empty_result(len(inds))
    if not inds:
        return out
    tables, splits, s_max, c_max, r_max = _prepare_tables(
        beagle, cohort, ad, inds, n_threshold, single_read_threshold,
        error_rate,
    )
    s_pad = _bucket(s_max, rt.site_multiple())
    c_pad = _bucket(c_max, 4)
    r_pad = _bucket(r_max, 4)
    # per-individual device footprint of the z-sums call: the scalar-
    # broadcast (depth, split) form in zscore_sums_batch_compact keeps
    # only [S]-wide temporaries, but XLA's schedule of the unrolled loop
    # holds tens of them live, so 256 bytes per site are budgeted.
    per_ind = s_pad * 256
    budget = Z_BLOCK_BYTES if block_bytes is None else block_bytes
    b = int(max(1, min(len(inds), budget // max(per_ind, 1))))

    # AF/EM group size, decoupled from the z-sums block size: the
    # per-problem EM/AF footprint (mode-dependent, via
    # per_ind_bytes_extra(s_pad, fill)) is usually a few [1, S] device
    # rows, orders of magnitude below the z-sums footprint that bounds
    # b — so the AF panels for MANY z-sum blocks are computed in one
    # af_block_fn call, and a population's problems share one batched EM
    # instead of one EM per individual.  ``fill`` (kept
    # fraction over the whole range) also fixes the reference-mode EM
    # structure for every block of this run, so the group sizing and the
    # structure choice can never disagree on memory.
    fill = float(
        sum(t.keep_sites.size for t in tables.values())
    ) / max(len(inds) * max(cohort.m_real, 1), 1)
    per_ind_af = max(per_ind_bytes_extra(s_pad, fill), 4 * s_pad)
    b_af = int(max(b, min(
        len(inds), AF_GROUP_MAX_INDS, AF_GROUP_BYTES // per_ind_af
    )))

    for glo in range(0, len(inds), b_af):
        g_inds = inds[glo : glo + b_af]
        g_block = _assemble_block(
            tables, splits, g_inds, len(g_inds), s_pad, c_pad, r_pad
        )
        af_group = af_block_fn(g_block, fill)  # [len(g_inds), s_pad] dev
        for lo in range(0, len(g_inds), b):
            chunk = g_inds[lo : lo + b]
            block = _assemble_block(
                tables, splits, chunk, b, s_pad, c_pad, r_pad
            )
            rows = np.arange(lo, lo + len(chunk), dtype=np.int32)
            if len(chunk) < b:  # padded slots repeat the last real row
                rows = np.concatenate(
                    [rows, np.full(b - len(chunk), rows[-1], np.int32)]
                )
            put = rt.replicate if rt.n_devices > 1 else jnp.asarray
            a_dev = _take_af_rows(af_group, put(rows))
            # per-site GLs and weights come from the device cohort
            # (keep-index gather), the [B, S, C] split tables expand on
            # device from the compact depth vectors — see _ZBlock's
            # docstring for why
            g0k_d, g1k_d, w_d = _gather_block_inputs(
                rt, cohort, block.keep,
                np.asarray(block.inds, np.int32), block.s_real,
            )
            w_obs, w_mu, w_var = zscore_sums_batch_compact(
                g0k_d, g1k_d, a_dev, w_d,
                rt.shard_axis(block.depth, 1),
                rt.replicate(block.rows_by_depth),
                rt.replicate(block.like_tab),
                rt.replicate(block.fact_tab),
            )
            w_obs = np.asarray(w_obs, dtype=np.float64)
            w_mu = np.asarray(w_mu, dtype=np.float64)
            w_var = np.asarray(w_var, dtype=np.float64)
            for slot in range(block.n_real):
                pos = glo + lo + slot
                _fill(
                    out, pos,
                    (w_obs[slot] - w_mu[slot]) / math.sqrt(w_var[slot]),
                    int(block.s_real[slot]),
                    w_obs[slot], w_mu[slot], w_var[slot],
                )
                if verbose:
                    _print_ind(block.inds[slot], out, pos)
    return out


@jax.jit
def _take_af_rows(af_group, rows):
    """Slice a z-sums block's AF rows out of the group panel (shard-local
    on a mesh: the site axis is the sharded one)."""
    return jnp.take(af_group, rows, axis=0)


def reference_z_scores(
    beagle: BeagleData,
    ad: np.ndarray,
    popmap: PopulationMap,
    ind_start: int = 0,
    ind_end: Optional[int] = None,
    n_threshold: int = 0,
    single_read_threshold: bool = False,
    max_iter: int = 200,
    tol: float = 1e-4,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    verbose: bool = False,
    block_bytes: Optional[int] = None,
    error_rate: float = SEQ_ERROR_RATE,
) -> ZScoreResult:
    """Reference mode: AF from a leave-one-out EM re-run of the individual's
    own population restricted to its kept sites (WGSassign.py:352-364).

    The reference's serial per-individual EM re-runs execute as
    one batched gather + EM per block of individuals
    (:func:`wgsassign_jax.ops.emmaf.em_maf_sites_batch`)."""
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    n = cohort.n_inds
    ind_end = n if ind_end is None else ind_end

    members_of = {}
    for i in range(ind_start, ind_end):
        members = popmap.members_of(popmap.pop_labels[i])
        members = members[members != i]
        if members.size == 0:
            raise ValueError(
                f"Individual {i} is the only member of its population; "
                "reference z-score needs a leave-one-out AF"
            )
        members_of[i] = members.astype(np.int32)
    p_pad = _bucket(max(m.size for m in members_of.values()), 8) \
        if members_of else 8

    # Two structures for the per-individual LOO EMs, chosen per block:
    #
    #   gathered       — [B, P, S] kept-site member panels, then the
    #                    batched sites EM.  Less compute when sites are
    #                    heavily filtered; the gather crosses shards.
    #   loo-structured — per population: shard-local [n_p, M] member panel
    #                    shared by its problems, full-site EM with
    #                    kept-site masks only in the convergence partials
    #                    (per-site independence => identical kept-site
    #                    trajectories), final small [B, S] gather.
    #
    # Multi-device always takes the loo-structured path (the cross-shard
    # panel gather would dominate); a single device takes it when most
    # sites are kept, while gathered wins under strong filtering.
    from wgsassign_jax.ops.emmaf import em_maf_loo_subset
    pop_members = {
        lab: popmap.members_of(lab).astype(np.int32)
        for lab in set(popmap.pop_labels[ind_start:ind_end])
    }

    def loo_structured_block(block: _ZBlock):
        m_pad = cohort.m_pad
        slots_by_pop = {}
        for slot, i in enumerate(block.inds):
            slots_by_pop.setdefault(popmap.pop_labels[i], []).append(slot)
        parts, slot_order = [], []
        for lab, slots in slots_by_pop.items():
            members = pop_members[lab]
            n_p = int(members.size)
            pos_of = {int(mm): idx for idx, mm in enumerate(members)}
            leave = np.asarray(
                [pos_of[block.inds[s]] for s in slots], np.int32
            )
            g0p, g1p = _member_panels_t(
                cohort.g0, cohort.g1,
                rt.replicate(members) if rt.n_devices > 1 else members,
            )
            w_full = _scatter_site_weight(
                rt, block.keep[slots], block.weight[slots], m_pad
            )
            s_real_g = np.maximum(block.s_real[slots], 1.0).astype(F32)
            put = rt.replicate if rt.n_devices > 1 else jnp.asarray
            f, _, _ = em_maf_loo_subset(
                g0p, g1p, put(leave), w_full, put(s_real_g), max_iter, tol,
            )
            # reference clamp with n = LOO member count n_p - 1
            parts.append(
                _gather_kept_af(rt, f, block.keep[slots],
                                1.0 / (2.0 * n_p))
            )
            slot_order.extend(slots)
        inv_order = np.argsort(np.asarray(slot_order)).astype(np.int32)
        put = rt.replicate if rt.n_devices > 1 else jnp.asarray
        return _reorder_concat(put(inv_order), *parts)

    def af_block(block: _ZBlock, fill: float):
        b = len(block.inds)
        if rt.n_devices > 1 or fill >= 0.5:
            return loo_structured_block(block)
        mem = np.zeros((b, p_pad), dtype=np.int32)
        mem_mask = np.zeros((b, p_pad), dtype=F32)
        for slot, i in enumerate(block.inds):
            m = members_of[i]
            mem[slot, : m.size] = m
            mem[slot, m.size :] = m[0]  # valid (masked) index
            mem_mask[slot, : m.size] = 1.0
        return _loo_af_block(
            cohort.g0, cohort.g1,
            rt.shard_axis(block.keep, 1),
            rt.replicate(mem), rt.replicate(mem_mask),
            rt.shard_axis(block.weight, 1),
            rt.replicate(np.maximum(block.s_real, 1.0)),
            max_iter, tol,
        )

    def extra_bytes(s_pad: int, fill: float) -> int:
        # sized for the EM structure af_block will take at this fill:
        # loo-structured shares per-population [n_p, M] panels, so each
        # problem adds only a few site rows (ft/sw/af); the gathered
        # path materializes two [P, S] member panels per problem
        if rt.n_devices > 1 or fill >= 0.5:
            return 16 * max(s_pad, cohort.m_pad)
        return 2 * p_pad * s_pad * 4

    return _run_blocks(
        cohort, beagle, ad, ind_start, ind_end, af_block, extra_bytes,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate,
    )


def assignment_z_scores(
    beagle: BeagleData,
    ad: np.ndarray,
    assigned_labels,
    af: np.ndarray,
    pops,
    ind_start: int = 0,
    ind_end: Optional[int] = None,
    n_threshold: int = 0,
    single_read_threshold: bool = False,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    verbose: bool = False,
    block_bytes: Optional[int] = None,
    error_rate: float = SEQ_ERROR_RATE,
) -> ZScoreResult:
    """Assignment mode: AF is the saved panel's column for the individual's
    *assigned* population, sliced at the kept sites (WGSassign.py:425-443)."""
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    n = cohort.n_inds
    ind_end = n if ind_end is None else ind_end
    af = np.asarray(af, F32)
    pops = np.asarray(pops, dtype=str)
    assigned_labels = np.asarray(assigned_labels, dtype=str)

    col_of = {}
    for i in range(ind_start, ind_end):
        hits = np.flatnonzero(pops == assigned_labels[i])
        if hits.size == 0:
            raise ValueError(
                f"Assigned population {assigned_labels[i]!r} of individual {i} "
                "not found in the population-names file"
            )
        col_of[i] = int(hits[0])

    from wgsassign_jax.models.common import pad_af_to

    # dimension hardening: a misaligned AF panel would otherwise gather
    # pad values / row-shifted AFs into silently wrong z-scores
    if af.shape[0] != cohort.m_real:
        raise ValueError(
            f"AF panel covers {af.shape[0]} sites, but the analysis covers "
            f"{cohort.m_real} — --pop_af_file must align row-for-row with "
            "the Beagle sites in use"
        )
    if af.shape[1] != len(pops):
        raise ValueError(
            f"AF panel has {af.shape[1]} populations, but the "
            f"--pop_names file lists {len(pops)}"
        )
    af_dev = rt.shard_sites(pad_af_to(af, cohort.m_pad))  # once per run

    def af_block(block: _ZBlock, fill: float):
        cols = np.asarray([col_of[i] for i in block.inds], np.int32)
        return _gather_af_block(rt, af_dev, block.keep, cols)

    return _run_blocks(
        cohort, beagle, ad, ind_start, ind_end, af_block,
        # keep-index upload (int32) + AF output + gather index temps
        lambda s, fill: 16 * s,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate,
    )


def _empty_result(n_sub: int) -> ZScoreResult:
    return ZScoreResult(
        z=np.empty(n_sub, dtype=F32),
        loci=np.empty(n_sub, dtype=np.int32),
        w_obs=np.empty(n_sub, dtype=F32),
        w_mu=np.empty(n_sub, dtype=F32),
        w_var=np.empty(n_sub, dtype=F32),
    )


def _fill(out: ZScoreResult, pos: int, z, loci, w_obs, w_mu, w_var):
    out.z[pos] = z
    out.loci[pos] = loci
    out.w_obs[pos] = w_obs
    out.w_mu[pos] = w_mu
    out.w_var[pos] = w_var


def _print_ind(i: int, out: ZScoreResult, pos: int):
    print(f"Finished individual {i}")
    print(f"z_mu: {out.w_mu[pos]}")
    print(f"z_var: {out.w_var[pos]}")
    print(f"z_obs: {out.w_obs[pos]}")
    print(f"Loci used: {out.loci[pos]}")
    print(f"Z-score: {out.z[pos]}")
