"""Test configuration: an 8-virtual-device CPU platform, set before any jax
use, so every test exercises the SNP-axis sharded code path on a mesh.

Tests that need an NVIDIA GPU take the ``gpu`` marker and the ``gpu_device``
fixture; they skip on the CPU mesh.  On a machine with the card,
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` runs them, and
``python chip_smoke.py`` drives the same paths end to end.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib

import pytest

DATA_DIR = pathlib.Path(__file__).parent / "data"
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

# Seeded cohort with the shapes of the upstream amre example, written by
# tests/generate_goldens.py (io/synth.py): 449 sites x 85 breeding
# individuals in five reference populations, a downsampled 357-site copy,
# 34 nonbreeding individuals from three harvest sites, and the allele
# depths behind each panel's GLs.
BREEDING_BEAGLE = DATA_DIR / "breeding.ind85.beagle.gz"
BREEDING_SUBSET_BEAGLE = DATA_DIR / "breeding.ind85.subset_80percent_sites.beagle.gz"
BREEDING_IDS = DATA_DIR / "breeding.ind85.reference_k5.IDs.txt"
BREEDING_AD = DATA_DIR / "breeding.ind85.ad.txt.gz"
NONBREEDING_BEAGLE = DATA_DIR / "nonbreeding.ind34.beagle.gz"
NONBREEDING_IDS = DATA_DIR / "nonbreeding.ind34.site.IDs.txt"
NONBREEDING_AD = DATA_DIR / "nonbreeding.ind34.ad.txt.gz"


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the platform has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; run on the card via chip_smoke.py")


@pytest.fixture(scope="session")
def breeding():
    from wgsassign_jax.io.beagle import read_beagle

    return read_beagle(str(BREEDING_BEAGLE))


@pytest.fixture(scope="session")
def breeding_ids():
    from wgsassign_jax.io.ids import read_ids

    return read_ids(str(BREEDING_IDS))


@pytest.fixture(scope="session")
def nonbreeding():
    from wgsassign_jax.io.beagle import read_beagle

    return read_beagle(str(NONBREEDING_BEAGLE))


@pytest.fixture(scope="session")
def nonbreeding_ids():
    from wgsassign_jax.io.ids import read_ids

    return read_ids(str(NONBREEDING_IDS))
