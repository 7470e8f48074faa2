"""Checkpoint/resume for long-running analyses.

The reference's only between-run state is its output files (SURVEY §5);
multi-million-SNP runs additionally want intra-run restart points.  Two
mechanisms:

- the LOO driver records each population's finished EM (one ``.npz`` per
  population next to the output prefix) and resumes at population
  granularity;
- the z-score ``--ind_start/--ind_end`` range restart (the reference's own
  manual sharding knob) is preserved at the CLI level.

Format: plain ``.npz``, atomic via temp-file rename, no external
dependencies.
"""

from __future__ import annotations

import os

import numpy as np


def save_npz_atomic(path: str, **arrays) -> None:
    """Write an npz atomically (temp file + rename)."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz when missing
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)
