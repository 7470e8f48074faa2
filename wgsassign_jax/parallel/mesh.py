"""Device mesh / sharding runtime.

Parallelism model (replacing the reference's OpenMP ``prange`` over the SNP
axis, emMAF_cy.pyx:16 etc.): a 1-D device mesh over axis ``"snp"``.  Genotype
likelihood panels ``[M, N]`` and AF panels ``[M, K]`` are sharded on their
site axis; membership matrices and per-pop scalars are replicated.  Every EM
update is pointwise in M, so the only cross-device traffic is the tiny
per-iteration convergence reduction and final log-likelihood sums — GSPMD
inserts the ``psum`` collectives from the sharding annotations.

Multi-host: ``jax.distributed.initialize`` + per-host shard loading composes
with the same mesh (each process contributes its local devices).  Single
device is the degenerate 1-mesh case — same code path throughout.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SNP_AXIS = "snp"

# Pad values forming a valid, numerically safe GL triple / AF.
PAD_G0 = 1.0
PAD_G1 = 0.0
PAD_AF = 0.5

@dataclass
class Runtime:
    """Holds the mesh and sharding helpers for one engine instance."""

    mesh: Mesh
    debug_checks: bool = False  # checkify sanitizers on the hot paths

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def engine(self) -> str:
        """The engine path on this mesh's platform.  Every device
        computation is plain JAX compiled by XLA: on an NVIDIA GPU no
        hand-written kernel has beaten XLA's code end to end."""
        d = self.mesh.devices.flat[0]
        return f"xla on {self.n_devices} x {d.device_kind} ({d.platform})"

    # -- shardings ---------------------------------------------------------
    def sites_sharding(self, ndim: int) -> NamedSharding:
        """Shard dim 0 (sites) over the mesh; replicate the rest."""
        spec = P(SNP_AXIS, *([None] * (ndim - 1)))
        return NamedSharding(self.mesh, spec)

    def replicated_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def shard_sites(self, x) -> jax.Array:
        x = np.asarray(x)
        return _put_global(x, self.sites_sharding(x.ndim))

    def replicate(self, x) -> jax.Array:
        return _put_global(np.asarray(x), self.replicated_sharding())

    def shard_axis(self, x, axis: int) -> jax.Array:
        """Shard an arbitrary axis (e.g. the site axis of a batched
        ``[B, S, ...]`` block) over the SNP mesh; replicate the rest.
        On a multi-process mesh the (identical-everywhere) host array is
        placed shard-by-shard, so the helpers work from every process."""
        x = np.asarray(x)
        spec = [None] * x.ndim
        spec[axis] = SNP_AXIS
        return _put_global(x, NamedSharding(self.mesh, P(*spec)))

    # -- padding -----------------------------------------------------------
    def site_multiple(self, extra: int = 1) -> int:
        """Sites are padded to a multiple of ``n_devices * extra``."""
        return self.n_devices * extra


def _put_global(x: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """device_put that also works when ``sharding`` spans processes this
    host cannot address: every process holds the full (identical) host
    array and contributes its addressable shards."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    from jax import make_array_from_callback

    return make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def pad_sites(arr: np.ndarray, multiple: int, pad_value: float) -> np.ndarray:
    """Pad dim 0 up to a multiple; returns the padded array."""
    m = arr.shape[0]
    m_pad = math.ceil(m / multiple) * multiple if multiple > 1 else m
    if m_pad == m:
        return arr
    pad_width = [(0, m_pad - m)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)


def site_weight_vector(m_real: int, m_pad: int) -> np.ndarray:
    w = np.zeros(m_pad, dtype=np.float32)
    w[:m_real] = 1.0
    return w


def make_runtime(
    devices: Optional[Sequence] = None,
    debug_checks: bool = False,
) -> Runtime:
    """Build a 1-D SNP-axis mesh over the given (default: all) devices and
    log its engine path once per mesh shape."""
    if devices is None:
        devices = jax.devices()
    mesh = Mesh(np.asarray(devices), (SNP_AXIS,))
    rt = Runtime(mesh=mesh, debug_checks=debug_checks)
    if rt.engine not in _LOGGED_ENGINES:
        _LOGGED_ENGINES.add(rt.engine)
        import logging

        logging.getLogger("wgsassign_jax").info("engine path: %s", rt.engine)
    return rt


_LOGGED_ENGINES: set = set()


def process_row_range(m_total: int, multiple: int = 1) -> tuple:
    """Contiguous SNP row range owned by this process.

    Multi-host data loading: each host parses only its own row range of the
    Beagle file (the format is row-streamable), then the global ``[M, ...]``
    device array is assembled from per-process shards with
    :func:`make_global_sites_array`.  Ranges are block-contiguous so they
    line up with a 1-D SNP mesh whose devices are ordered by process.
    """
    nproc = jax.process_count()
    pid = jax.process_index()
    m_pad = math.ceil(m_total / (multiple * nproc)) * (multiple * nproc)
    per = m_pad // nproc
    lo = pid * per
    hi = min(m_total, lo + per)
    return lo, max(hi, lo), per


def make_global_sites_array(runtime: Runtime, local_rows: np.ndarray, m_global: int):
    """Assemble a site-sharded global array from this process's block of
    rows (padded to the per-process size).  Single-process meshes fall back
    to a plain sharded device_put."""
    if jax.process_count() == 1:
        return runtime.shard_sites(local_rows)
    from jax import make_array_from_process_local_data

    sharding = runtime.sites_sharding(local_rows.ndim)
    global_shape = (m_global,) + tuple(local_rows.shape[1:])
    return make_array_from_process_local_data(sharding, local_rows, global_shape)


def fetch_to_host(x) -> np.ndarray:
    """Bring a device array to host memory, working for *any* sharding.

    Single-process (and replicated multi-process) arrays are fully
    addressable and copy directly; site-sharded arrays in a multi-process
    run are first all-gathered to every host (process_allgather replicates
    via a jit identity).  Every model's host-side result download goes
    through this, so the same code path serves 1 chip and a pod slice.
    """
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    # tiled=True is the (required) global-array mode: the array is
    # replicated via a jit identity and returned with its global shape
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def is_primary() -> bool:
    """True on the process that owns user-facing output (files, stdout)."""
    return jax.process_index() == 0


def enable_compilation_cache() -> str:
    """Keep JAX's persistent compilation cache where
    ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that variable itself), or
    else in ``.jax_cache/`` at the root of the checkout, so later processes
    reuse compiled programs.  Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            ".jax_cache",
        )
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def maybe_initialize_distributed() -> None:
    """Initialize jax.distributed when launched under a multi-host
    coordinator (env-var driven; no-op for single-process runs)."""
    if os.environ.get("WGSA_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=os.environ["WGSA_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ["WGSA_NUM_PROCESSES"]),
            process_id=int(os.environ["WGSA_PROCESS_ID"]),
        )
