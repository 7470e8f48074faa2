"""Seeded cohort generation (io/synth.py) and device placement of
generated panels (models/common.place_panels)."""

import jax
import numpy as np
import pytest

from wgsassign_jax.io.synth import (
    population_afs,
    sample_reads,
    synth_cohort,
    synth_device_panels,
)
from wgsassign_jax.models.common import place_panels
from wgsassign_jax.parallel.mesh import PAD_G0, PAD_G1, make_runtime


def test_sample_reads_gls_follow_depths():
    rng = np.random.default_rng(0)
    af = population_afs(200, 3, 0.1, rng)
    gl, ad = sample_reads(af, np.array([0, 1, 2, 2]), rng)
    assert gl.shape == (200, 4, 2) and ad.shape == (200, 8)
    # no reads -> uninformative GLs (1/3 each)
    empty = (ad[:, 0::2] + ad[:, 1::2]) == 0
    np.testing.assert_allclose(gl[empty], 1.0 / 3.0, atol=1e-6)
    assert (gl.sum(axis=-1) <= 1.0 + 1e-6).all()


def test_synth_cohort_is_seeded():
    a = synth_cohort(50, 10, seed=4)
    b = synth_cohort(50, 10, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_synth_device_panels_shapes_and_validity():
    g0, g1, pop_of = synth_device_panels(1000, [3, 5], seed=1, chunk=256)
    assert g0.shape == g1.shape == (1000, 8)
    np.testing.assert_array_equal(pop_of, [0, 0, 0, 1, 1, 1, 1, 1])
    g0, g1 = np.asarray(g0), np.asarray(g1)
    assert np.isfinite(g0).all() and np.isfinite(g1).all()
    assert (g0 >= 0).all() and (g1 >= 0).all() and (g0 + g1 <= 1 + 1e-6).all()
    again = synth_device_panels(1000, [3, 5], seed=1, chunk=256)
    np.testing.assert_array_equal(g0, np.asarray(again[0]))


@pytest.mark.parametrize("n_dev,extra", [(1, 1), (8, 1), (8, 3)])
def test_place_panels_pads_and_shards(n_dev, extra):
    rt = make_runtime(jax.devices()[:n_dev])
    g0, g1, _ = synth_device_panels(101, [2, 2], seed=2)
    c = place_panels(g0, g1, rt, site_multiple=extra)
    assert c.m_real == 101 and c.m_pad % (n_dev * extra) == 0
    assert c.g0.sharding.spec == rt.sites_sharding(2).spec
    np.testing.assert_array_equal(np.asarray(c.g0)[:101], np.asarray(g0))
    np.testing.assert_array_equal(np.asarray(c.g0)[101:], PAD_G0)
    np.testing.assert_array_equal(np.asarray(c.g1)[101:], PAD_G1)
    w = np.asarray(c.site_weight)
    assert w[:101].all() and not w[101:].any()
