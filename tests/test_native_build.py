"""The native Beagle parser's library is built per host from the committed
source, and a failed build falls back to the pure-Python parser with a
logged warning."""

import logging
import os
import platform

import numpy as np

from conftest import BREEDING_BEAGLE


def test_library_name_keyed_by_host_and_source(monkeypatch):
    from wgsassign_jax import _native

    path = _native._lib_path()
    assert os.path.dirname(path) == _native._BUILD_DIR
    assert f"-{platform.machine()}-" in os.path.basename(path)
    monkeypatch.setattr(_native, "_cpu_flags", lambda: "another cpu")
    assert _native._lib_path() != path


def test_native_library_loads_from_build_dir():
    from wgsassign_jax import _native

    lib = _native._get_lib()
    assert lib is not None
    assert lib._name == _native._lib_path()


def test_failed_build_falls_back_with_warning(monkeypatch, caplog):
    from wgsassign_jax import _native
    from wgsassign_jax.io.beagle import read_beagle

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_build_failed", False)
    monkeypatch.setattr(_native, "_build", lambda: None)
    with caplog.at_level(logging.WARNING, logger="wgsassign_jax"):
        data = read_beagle(str(BREEDING_BEAGLE))
    assert any("pure-Python parser" in r.message for r in caplog.records)
    assert data.gl.shape == (449, 85, 2) and np.isfinite(data.gl).all()
