"""Shared device-side cohort container used by every analysis."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np

from wgsassign_jax.io.beagle import BeagleData, BeagleShard
from wgsassign_jax.parallel.mesh import (
    PAD_G0,
    PAD_G1,
    PAD_AF,
    Runtime,
    make_global_sites_array,
    make_runtime,
    pad_sites,
    site_weight_vector,
)


@dataclass
class DeviceCohort:
    """Genotype likelihood panels resident on device.

    ``g0``/``g1`` are float32 ``[M_pad, N]``, sharded over the SNP axis;
    ``site_weight`` is 1.0 on the first ``m_real`` rows, 0.0 on padding.
    """

    g0: jax.Array
    g1: jax.Array
    site_weight: jax.Array
    m_real: int
    runtime: Runtime

    @property
    def m_pad(self) -> int:
        return self.g0.shape[0]

    @property
    def n_inds(self) -> int:
        return self.g0.shape[1]


def to_device(
    beagle,
    runtime: Optional[Runtime] = None,
    site_multiple: int = 1,
) -> DeviceCohort:
    """Pad + shard a parsed Beagle matrix onto the mesh.

    ``site_multiple`` adds an extra divisibility requirement on the padded
    site count (e.g. the partition count for partitioned log-likelihoods).

    Accepts either a fully parsed :class:`BeagleData` or a per-process
    :class:`BeagleShard` (multi-host): shards are padded to the per-process
    block size and assembled into global SNP-sharded arrays without any
    host holding the full matrix.
    """
    if runtime is None:
        runtime = make_runtime()
    if isinstance(beagle, BeagleShard):
        return _shard_to_device(beagle, runtime, site_multiple)
    mult = runtime.site_multiple(site_multiple)
    g0_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 0]), mult, PAD_G0)
    g1_h = pad_sites(np.ascontiguousarray(beagle.gl[:, :, 1]), mult, PAD_G1)
    m_real = beagle.n_sites
    w = site_weight_vector(m_real, g0_h.shape[0])
    return DeviceCohort(
        g0=runtime.shard_sites(g0_h),
        g1=runtime.shard_sites(g1_h),
        site_weight=runtime.shard_sites(w),
        m_real=m_real,
        runtime=runtime,
    )


def place_panels(g0, g1, runtime: Optional[Runtime] = None,
                 site_multiple: int = 1) -> DeviceCohort:
    """:func:`to_device` for GL panels that are already device arrays
    (``[M, N]`` float32 each, e.g. generated on device): pad the site axis
    on device and shard it over the mesh."""
    import jax.numpy as jnp

    if runtime is None:
        runtime = make_runtime()
    m_real = g0.shape[0]
    mult = runtime.site_multiple(site_multiple)
    pad = -m_real % mult
    sharding = runtime.sites_sharding(2)
    g0 = jax.device_put(jnp.pad(g0, ((0, pad), (0, 0)),
                                constant_values=PAD_G0), sharding)
    g1 = jax.device_put(jnp.pad(g1, ((0, pad), (0, 0)),
                                constant_values=PAD_G1), sharding)
    return DeviceCohort(
        g0=g0, g1=g1,
        site_weight=runtime.shard_sites(site_weight_vector(m_real, m_real + pad)),
        m_real=m_real, runtime=runtime,
    )


def _shard_to_device(shard: BeagleShard, runtime: Runtime,
                     site_multiple: int) -> DeviceCohort:
    """Assemble a global SNP-sharded cohort from per-process row blocks."""
    import jax

    nproc = jax.process_count()
    per = shard.rows_per_process
    # window consistency: the shard must have been cut for this runtime's
    # padding requirements (same mesh, same partition count)
    mult_local = runtime.site_multiple(site_multiple) // max(nproc, 1)
    if per % max(mult_local, 1) != 0:
        raise ValueError(
            f"BeagleShard block size {per} incompatible with the runtime's "
            f"per-process site multiple {mult_local}; re-read with "
            "read_beagle_sharded(path, runtime, site_multiple)"
        )
    m_pad = per * nproc
    n_local = shard.hi - shard.lo

    def pad_block(a: np.ndarray, fill) -> np.ndarray:
        out = np.full((per,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    g0_l = pad_block(np.ascontiguousarray(shard.local.gl[:, :, 0]), PAD_G0)
    g1_l = pad_block(np.ascontiguousarray(shard.local.gl[:, :, 1]), PAD_G1)
    w_l = pad_block(np.ones(n_local, dtype=np.float32), 0.0)
    return DeviceCohort(
        g0=make_global_sites_array(runtime, g0_l, m_pad),
        g1=make_global_sites_array(runtime, g1_l, m_pad),
        site_weight=make_global_sites_array(runtime, w_l, m_pad),
        m_real=shard.m_global,
        runtime=runtime,
    )


_STREAM_ALLOC_CACHE: dict = {}


def _stream_alloc(device, shape, fill):
    """Allocate a committed single-device buffer without a host copy.
    The jitted allocator is cached per (shape, fill, device) so repeated
    ingests reuse one compiled program per buffer class."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import SingleDeviceSharding

    key = (tuple(shape), float(fill), device)
    fn = _STREAM_ALLOC_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            lambda: jnp.full(shape, fill, jnp.float32),
            out_shardings=SingleDeviceSharding(device),
        )
        _STREAM_ALLOC_CACHE[key] = fn
    return fn()


def _stream_update2(dst0, dst1, src3, off):
    """Donated in-place row-window write of BOTH GL planes from one
    contiguous parser block.  The ``[b, N, 2]`` block is staged host->device
    exactly as the tokenizer produced it (one transfer, no host-side
    de-interleave copies); the per-plane split happens on device."""
    import jax

    if not hasattr(_stream_update2, "_fn"):
        def _upd(d0, d1, s, o):
            return (
                jax.lax.dynamic_update_slice(d0, s[:, :, 0], (o, 0)),
                jax.lax.dynamic_update_slice(d1, s[:, :, 1], (o, 0)),
            )

        _stream_update2._fn = jax.jit(_upd, donate_argnums=(0, 1))
    import numpy as _np

    return _stream_update2._fn(dst0, dst1, src3, _np.int32(off))


def _stream_overlap_default() -> bool:
    """Whether parsing should overlap device placement (prefetch thread).

    On hosts with few cores the tokenizer threads and the runtime's
    host->device transfer machinery fight for the same CPUs; measured on a
    2-core host the contended transfer collapses ~40x (1.3 GB/s -> 35 MB/s),
    so strict parse/upload ALTERNATION is faster than overlap there.  With
    >= 4 cores the transfer threads get their own core and overlap wins.
    Override with WGSA_STREAM_OVERLAP=0/1."""
    env = os.environ.get("WGSA_STREAM_OVERLAP")
    if env is not None:
        return env not in ("0", "false", "False")
    return (os.cpu_count() or 1) >= 4


def stream_to_device(
    path: str,
    runtime: Optional[Runtime] = None,
    site_multiple: int = 1,
    block_rows: Optional[int] = None,
    use_native: bool = True,
    collect_site_names: bool = False,
    n_threads: Optional[int] = None,
    keep_mask: Optional[np.ndarray] = None,
):
    """Build a :class:`DeviceCohort` directly from a Beagle file in site
    blocks, without ever materializing the full ``[M, N, 2]`` matrix on the
    host (the reference holds all of M resident, reader_cy.pyx:71).

    Pipeline: each parsed block is written into per-device buffers via one
    donated ``dynamic_update_slice`` transfer (in-place on device, planes
    split device-side); the buffers are assembled into global SNP-sharded
    arrays at the end.  Peak host memory is O(block); M is bounded by
    aggregate device memory, not host RAM.  On hosts with >= 4 cores a
    prefetch thread parses block i+1 while block i transfers; on smaller
    hosts parse and transfer strictly alternate instead (see
    :func:`_stream_overlap_default`).

    Multi-host: each process streams only its own contiguous row window
    (rows before it are decompressed and line-counted, never
    float-tokenized) into its local devices' buffers — no host ever
    materializes even its *shard* of the GL matrix, removing the last
    host-RAM bound of the multi-host path (``read_beagle_sharded`` holds
    ``[M/nproc, N, 2]`` resident per host).

    ``keep_mask`` (bool ``[file_rows]``) drops masked data rows on the fly
    — the streamed form of the downsampled-LOO site intersection; the
    cohort then covers only the kept rows, in order.  Multi-host processes
    map their kept-row window back to the smallest original row range and
    mask locally.

    Returns ``(cohort, meta, site_names)`` where ``meta`` is a
    :class:`wgsassign_jax.io.stream.BeagleStreamMeta` and ``site_names``
    is None unless ``collect_site_names`` (single-process only: it
    reintroduces an O(M) host cost and is meant for tests / small runs).
    """
    import math as _math

    import jax

    from wgsassign_jax.io.beagle import beagle_dims
    from wgsassign_jax.io.stream import (
        BeagleStreamMeta,
        open_block_iterator,
        prefetch,
    )

    if runtime is None:
        runtime = make_runtime()
    nproc = jax.process_count()
    pid = jax.process_index()
    if collect_site_names and nproc > 1:
        raise ValueError(
            "collect_site_names would return only this process's window "
            "under multi-host streaming"
        )
    mult = runtime.site_multiple(site_multiple)
    if mult % nproc != 0:
        raise ValueError(
            f"site multiple {mult} does not divide over {nproc} processes"
        )
    m_scan, n = beagle_dims(path, use_native=use_native)

    positions = None
    if keep_mask is not None:
        keep_mask = np.asarray(keep_mask, dtype=bool)
        if keep_mask.shape[0] != m_scan:
            raise ValueError(
                f"keep_mask covers {keep_mask.shape[0]} rows, Beagle file "
                f"{path} has {m_scan}"
            )
        positions = np.flatnonzero(keep_mask)
        m_real = int(positions.size)
    else:
        m_real = m_scan

    m_pad = _math.ceil(max(m_real, 1) / mult) * mult
    n_dev = runtime.n_devices
    per_dev = m_pad // n_dev
    per_proc = m_pad // nproc

    if block_rows is None:
        # ~256 MiB of parsed GL (2 float32s per site-individual) per block
        block_rows = max((256 << 20) // (8 * max(n, 1)), 1)
    block_rows = max(_math.ceil(block_rows / mult) * mult, mult)

    # this process's window over the *kept* rows, then mapped back to the
    # smallest original-row range (filtering preserves order)
    lo_p = pid * per_proc
    # clamp: a process whose whole window lies in the padded tail
    # (lo_p >= m_real, possible when m_real < nproc * per_proc) must see an
    # empty window, not hi_p < lo_p (which would trip the shrank-file check)
    hi_p = max(lo_p, min(m_real, lo_p + per_proc))
    local_mask = None
    if hi_p > lo_p:
        if positions is not None:
            orig_lo = int(positions[lo_p])
            orig_hi = int(positions[hi_p - 1]) + 1
            local_mask = keep_mask[orig_lo:orig_hi]
        else:
            orig_lo, orig_hi = lo_p, hi_p
        _meta, blocks = open_block_iterator(
            path, block_rows, use_native, n_threads=n_threads,
            row_range=(orig_lo, orig_hi), dims=(m_scan, n),
        )
        if local_mask is not None:
            blocks = _rechunk_filtered(blocks, local_mask, block_rows)
        sample_names = _meta.sample_names
    else:  # more processes than row blocks: empty window
        _meta, blocks = open_block_iterator(
            path, block_rows, use_native, n_threads=n_threads,
            row_range=(0, 0), dims=(m_scan, n),
        )
        sample_names = _meta.sample_names
    meta = BeagleStreamMeta(m_scan, n, sample_names)

    # local devices in global mesh order; their row windows must tile this
    # process's [lo_p, lo_p + per_proc) block contiguously (the same
    # assumption the non-streamed multi-host assembly makes)
    mesh_devs = list(runtime.mesh.devices.flat)
    my_pos = [i for i, d in enumerate(mesh_devs) if d.process_index == pid]
    if not my_pos:
        raise ValueError(
            "this process owns no devices of the mesh (e.g. --devices "
            "trimmed them away); streamed ingest needs every process to "
            "hold a contiguous row block"
        )
    if (my_pos != list(range(my_pos[0], my_pos[0] + len(my_pos)))
            or my_pos[0] * per_dev != lo_p
            or len(my_pos) * per_dev != per_proc):
        raise ValueError(
            "mesh devices are not process-contiguous; streamed ingest "
            "needs each process's devices to own one contiguous row block"
        )

    g0_bufs = {d: _stream_alloc(mesh_devs[d], (per_dev, n), PAD_G0)
               for d in my_pos}
    g1_bufs = {d: _stream_alloc(mesh_devs[d], (per_dev, n), PAD_G1)
               for d in my_pos}

    site_names = [] if collect_site_names else None
    overlap = _stream_overlap_default()
    block_iter = prefetch(blocks) if overlap else iter(blocks)
    wlo = 0  # rows of this process's window placed so far
    for gl_block, names in block_iter:
        b = gl_block.shape[0]
        if lo_p + wlo + b > hi_p:
            raise ValueError(
                f"Beagle file {path} grew during streaming ingest "
                f"({lo_p + wlo + b} rows > dims scan {hi_p})"
            )
        done = 0
        while done < b:  # split at device boundaries (rows are ascending)
            gpos = lo_p + wlo + done
            di = gpos // per_dev
            doff = gpos % per_dev
            take = min(b - done, per_dev - doff)
            # one contiguous [take, N, 2] transfer; planes split on device
            src = gl_block[done : done + take]
            if not overlap:
                # strict parse/upload alternation: stage the block with an
                # explicit device_put and wait for the TRANSFER itself
                # before the tokenizer threads take the CPUs back.  Waiting
                # on the donated-update result is not enough — the runtime
                # streams a numpy argument asynchronously, so the client-
                # side transfer work would land in the next parse window
                # and the two would contend anyway (measured ~40x transfer
                # collapse on a 2-core host; see _stream_overlap_default).
                src = jax.device_put(src, mesh_devs[di])
                src.block_until_ready()
            g0_bufs[di], g1_bufs[di] = _stream_update2(
                g0_bufs[di], g1_bufs[di], src, doff,
            )
            done += take
        if not overlap:
            g0_bufs[di].block_until_ready()
        if site_names is not None:
            site_names.extend(names)
        wlo += b
    if lo_p + wlo != hi_p:
        raise ValueError(
            f"Beagle file {path} shrank during streaming ingest "
            f"({lo_p + wlo} rows < dims scan {hi_p})"
        )

    # per-device site weights (1.0 on real rows) — O(per_dev) host floats
    w_bufs = {}
    for d in my_pos:
        rows = np.arange(d * per_dev, (d + 1) * per_dev)
        w_bufs[d] = jax.device_put(
            (rows < m_real).astype(np.float32), mesh_devs[d]
        )

    def assemble(bufs, ndim):
        sharding = runtime.sites_sharding(ndim)
        shape = (m_pad, n) if ndim == 2 else (m_pad,)
        return jax.make_array_from_single_device_arrays(
            shape, sharding, [bufs[d] for d in my_pos]
        )

    cohort = DeviceCohort(
        g0=assemble(g0_bufs, 2),
        g1=assemble(g1_bufs, 2),
        site_weight=assemble(w_bufs, 1),
        m_real=m_real,
        runtime=runtime,
    )
    return cohort, meta, site_names


def _rechunk_filtered(blocks, keep_mask: np.ndarray, block_rows: int):
    """Apply a row keep-mask to a Beagle block stream and re-chunk the
    surviving rows into full ``block_rows`` blocks (+ one tail), so the
    device-placement loop keeps its two compiled update shapes."""
    buf_gl, buf_names, have, pos = [], [], 0, 0
    for gl_block, names in blocks:
        b = gl_block.shape[0]
        sel = keep_mask[pos : pos + b]
        pos += b
        if sel.any():
            buf_gl.append(gl_block[sel])
            buf_names.append([nm for nm, k in zip(names, sel) if k])
            have += int(sel.sum())
        while have >= block_rows:
            gl_cat = np.concatenate(buf_gl) if len(buf_gl) > 1 else buf_gl[0]
            names_cat = [nm for chunk in buf_names for nm in chunk]
            yield gl_cat[:block_rows], names_cat[:block_rows]
            rest = gl_cat[block_rows:]
            buf_gl = [rest] if rest.shape[0] else []
            buf_names = [names_cat[block_rows:]] if rest.shape[0] else []
            have -= block_rows
    if have:
        gl_cat = np.concatenate(buf_gl) if len(buf_gl) > 1 else buf_gl[0]
        yield gl_cat, [nm for chunk in buf_names for nm in chunk]


def pad_af_to(af: np.ndarray, m_pad: int) -> np.ndarray:
    """Pad an ``[M, K]`` AF panel's site axis up to ``m_pad`` with 0.5."""
    m = af.shape[0]
    if m == m_pad:
        return af
    return np.pad(af, [(0, m_pad - m), (0, 0)], constant_values=PAD_AF)
