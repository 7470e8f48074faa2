import numpy as np
import pytest

from conftest import BREEDING_AD, GOLDEN_DIR, NONBREEDING_AD

from wgsassign_jax.io.ad import read_allele_depths
from wgsassign_jax.models.zscore import (
    FilteringError,
    assignment_z_scores,
    build_combo_tables,
    reference_z_scores,
)


@pytest.fixture(scope="module")
def breeding_ad():
    return read_allele_depths(str(BREEDING_AD))


@pytest.fixture(scope="module")
def nonbreeding_ad():
    return read_allele_depths(str(NONBREEDING_AD))


def test_reference_z_matches_golden(breeding, breeding_ids, breeding_ad):
    golden = np.load(GOLDEN_DIR / "zscore_reference.npz")
    res = reference_z_scores(
        breeding, breeding_ad, breeding_ids, n_threshold=int(golden["threshold"])
    )
    np.testing.assert_array_equal(res.loci, golden["loci"])
    np.testing.assert_allclose(res.z, golden["z"], rtol=2e-3, atol=2e-3)


def test_assignment_z_matches_golden(nonbreeding, nonbreeding_ad):
    golden = np.load(GOLDEN_DIR / "zscore_assignment.npz")
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    ids = np.loadtxt(
        GOLDEN_DIR / "nonbreeding_assigned_ids.txt", delimiter="\t", dtype=str
    )
    res = assignment_z_scores(
        nonbreeding,
        nonbreeding_ad,
        ids[:, 1],
        af,
        pops,
        n_threshold=int(golden["threshold"]),
    )
    np.testing.assert_array_equal(res.loci, golden["loci"])
    np.testing.assert_allclose(res.z, golden["z"], rtol=2e-3, atol=2e-3)


def test_ind_range(nonbreeding, nonbreeding_ad):
    golden = np.load(GOLDEN_DIR / "zscore_assignment.npz")
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    ids = np.loadtxt(
        GOLDEN_DIR / "nonbreeding_assigned_ids.txt", delimiter="\t", dtype=str
    )
    res = assignment_z_scores(
        nonbreeding, nonbreeding_ad, ids[:, 1], af, pops,
        ind_start=3, ind_end=5, n_threshold=int(golden["threshold"]),
    )
    np.testing.assert_allclose(res.z, golden["z"][3:5], rtol=2e-3, atol=2e-3)


def test_combo_tables_depth_classes(breeding, breeding_ad):
    """Every kept depth class must contain all of its D+1 splits."""
    t = build_combo_tables(
        breeding.gl[:, 0, :], breeding_ad[:, 0:2], n_threshold=5,
        single_read_threshold=False,
    )
    combos = {(int(a), int(b)) for a, b in t.combos}
    for d in np.unique(t.combos.sum(axis=1)):
        for x in range(int(d) + 1):
            assert (int(d - x), int(x)) in combos


def test_single_read_threshold(breeding, breeding_ad):
    t = build_combo_tables(
        breeding.gl[:, 0, :], breeding_ad[:, 0:2], n_threshold=0,
        single_read_threshold=True,
    )
    assert set(t.combos.sum(axis=1)) == {1}


def test_too_stringent_raises(breeding, breeding_ad):
    with pytest.raises(FilteringError):
        build_combo_tables(
            breeding.gl[:, 0, :], breeding_ad[:, 0:2], n_threshold=10**9,
            single_read_threshold=False,
        )


def test_blocked_equals_single_block(nonbreeding, nonbreeding_ad):
    """Forcing tiny device blocks (multiple blocks + a repeat-padded final
    block) must reproduce the single-block batched results exactly."""
    golden = np.load(GOLDEN_DIR / "zscore_assignment.npz")
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    ids = np.loadtxt(
        GOLDEN_DIR / "nonbreeding_assigned_ids.txt", delimiter="\t", dtype=str
    )
    kwargs = dict(n_threshold=int(golden["threshold"]))
    full = assignment_z_scores(
        nonbreeding, nonbreeding_ad, ids[:, 1], af, pops, **kwargs
    )
    blocked = assignment_z_scores(
        nonbreeding, nonbreeding_ad, ids[:, 1], af, pops,
        block_bytes=1, **kwargs
    )
    np.testing.assert_array_equal(blocked.loci, full.loci)
    np.testing.assert_allclose(blocked.z, full.z, rtol=1e-6, atol=1e-6)


def test_blocked_reference_mode(breeding, breeding_ids, breeding_ad):
    golden = np.load(GOLDEN_DIR / "zscore_reference.npz")
    blocked = reference_z_scores(
        breeding, breeding_ad, breeding_ids,
        n_threshold=int(golden["threshold"]), block_bytes=200_000,
    )
    np.testing.assert_array_equal(blocked.loci, golden["loci"])
    np.testing.assert_allclose(blocked.z, golden["z"], rtol=2e-3, atol=2e-3)


def test_compact_zsums_match_legacy():
    """zscore_sums_batch_compact (device-expanded site-minor tables) must
    reproduce the legacy host-expanded zscore_sums_batch bit-for-bit-ish
    on random combo tables."""
    import jax.numpy as jnp

    from wgsassign_jax.ops.zscore_ops import (
        zscore_sums_batch,
        zscore_sums_batch_compact,
    )

    rng = np.random.default_rng(97)
    b, s, c, r = 3, 64, 6, 12
    gl = rng.dirichlet(np.ones(3), (b, s)).astype(np.float32)
    g0k, g1k = gl[:, :, 0], gl[:, :, 1]
    a = rng.uniform(0.05, 0.95, (b, s)).astype(np.float32)
    weight = (rng.random((b, s)) < 0.8).astype(np.float32)
    depth = rng.integers(1, c, (b, s)).astype(np.int32)
    rows_by_depth = rng.integers(0, r, (b, c, c)).astype(np.int32)
    like_tab = rng.dirichlet(np.ones(3), (b, r)).astype(np.float32)
    fact_tab = rng.uniform(0.01, 1.0, (b, r, 3)).astype(np.float32)

    # legacy expansion on host
    rows = np.zeros((b, s, c), np.int32)
    mask = np.zeros((b, s, c), np.float32)
    for i in range(b):
        rows[i] = rows_by_depth[i][depth[i]]
        mask[i] = (np.arange(c)[None, :] <= depth[i][:, None]).astype(
            np.float32
        )
    legacy = zscore_sums_batch(
        *map(jnp.asarray, (g0k, g1k, a, weight, rows, mask,
                           like_tab, fact_tab))
    )
    compact = zscore_sums_batch_compact(
        *map(jnp.asarray, (g0k, g1k, a, weight, depth, rows_by_depth,
                           like_tab, fact_tab))
    )
    for x, y in zip(compact, legacy):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-4
        )


def test_assignment_af_dim_validation(breeding, breeding_ids):
    """A misaligned --pop_af_file must fail loudly, not gather pad values
    into silently wrong z-scores (round-4 review finding)."""
    from wgsassign_jax.models.zscore import assignment_z_scores

    ad = read_allele_depths(str(BREEDING_AD))
    ref = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)
    af_short = ref["af"][:100]
    with pytest.raises(ValueError, match="covers 100 sites"):
        assignment_z_scores(
            breeding, ad, breeding_ids.pop_labels, af_short, ref["pops"],
            0, 2, 0, False,
        )
    af_narrow = ref["af"][:, :3]
    with pytest.raises(ValueError, match="has 3 populations"):
        assignment_z_scores(
            breeding, ad, breeding_ids.pop_labels, af_narrow, ref["pops"],
            0, 2, 0, False,
        )


def test_reference_zscore_sharded_matches_golden(breeding, breeding_ids):
    """reference_z_scores on the 8-device mesh takes the shard-local
    LOO-subset EM and still hits the goldens."""
    import jax

    from wgsassign_jax.parallel.mesh import make_runtime

    golden = np.load(GOLDEN_DIR / "zscore_reference.npz")
    thr = int(golden["threshold"])
    ad = read_allele_depths(str(BREEDING_AD))
    rt = make_runtime(jax.devices())
    assert rt.n_devices == 8
    res = reference_z_scores(
        breeding, ad, breeding_ids, 0, 5, thr, False, runtime=rt
    )
    np.testing.assert_allclose(res.z, golden["z"][:5], rtol=2e-3, atol=2e-3)
