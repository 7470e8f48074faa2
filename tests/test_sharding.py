"""Mesh-size invariance: every analysis must give the same answer on a
1-device and an 8-device SNP-axis mesh (the collectives GSPMD inserts for
the sharded reductions must not change results beyond fp noise)."""

import jax
import numpy as np
import pytest

from wgsassign_jax.models.assign import assignment_loglikelihoods
from wgsassign_jax.models.loo import leave_one_out
from wgsassign_jax.models.ne import effective_sample_sizes
from wgsassign_jax.models.reference_af import estimate_reference_af
from wgsassign_jax.parallel.mesh import make_runtime

from conftest import GOLDEN_DIR


@pytest.fixture(scope="module")
def runtimes():
    devs = jax.devices()
    assert len(devs) >= 8, "tests expect the 8-virtual-device CPU platform"
    return make_runtime(devs[:1]), make_runtime(devs)


def test_reference_af_mesh_invariant(breeding, breeding_ids, runtimes):
    rt1, rt8 = runtimes
    a = estimate_reference_af(breeding, breeding_ids, runtime=rt1)
    b = estimate_reference_af(breeding, breeding_ids, runtime=rt8)
    np.testing.assert_array_equal(a.iters, b.iters)
    np.testing.assert_allclose(a.af, b.af, atol=1e-6)


def test_assign_mesh_invariant(nonbreeding, runtimes):
    rt1, rt8 = runtimes
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    a = assignment_loglikelihoods(nonbreeding, af, runtime=rt1)
    b = assignment_loglikelihoods(nonbreeding, af, runtime=rt8)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=5e-4)


def test_loo_mesh_invariant(breeding, breeding_ids, runtimes):
    rt1, rt8 = runtimes
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    a = leave_one_out(breeding, af, breeding_ids, runtime=rt1)
    b = leave_one_out(breeding, af, breeding_ids, runtime=rt8)
    np.testing.assert_array_equal(a.iters, b.iters)
    np.testing.assert_allclose(a.ll, b.ll, rtol=1e-6, atol=5e-4)


def test_ne_mesh_invariant(breeding, breeding_ids, runtimes):
    rt1, rt8 = runtimes
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    a = effective_sample_sizes(breeding, af, breeding_ids, runtime=rt1)
    b = effective_sample_sizes(breeding, af, breeding_ids, runtime=rt8)
    np.testing.assert_allclose(a.f_obs, b.f_obs, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(a.ne_ind, b.ne_ind, rtol=1e-5, atol=1e-4)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (1024, 4)
    ge.dryrun_multichip(8)
