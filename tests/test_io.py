import gzip

import numpy as np
import pytest

from wgsassign_jax.io.beagle import (
    filter_sites_to_common,
    read_beagle,
    to_legacy_matrix,
)
from wgsassign_jax.io.ids import population_map, read_ids

from conftest import BREEDING_BEAGLE, BREEDING_IDS, BREEDING_SUBSET_BEAGLE


def test_read_beagle_shapes(breeding):
    assert breeding.gl.shape == (449, 85, 2)
    assert breeding.gl.dtype == np.float32
    assert len(breeding.sample_names) == 85
    assert len(breeding.site_names) == 449
    assert breeding.sample_names[0] == "Ind0"
    assert breeding.site_names[0].startswith("scaffold")


def test_read_beagle_values(breeding):
    # hand-decoded first data row of the bundled file
    with gzip.open(BREEDING_BEAGLE, "rt") as f:
        f.readline()
        row = f.readline().split()
    vals = np.array(row[3:], dtype=np.float32).reshape(85, 3)
    np.testing.assert_array_equal(breeding.gl[0], vals[:, :2])
    # triples are normalized
    g2 = 1.0 - breeding.gl[:, :, 0] - breeding.gl[:, :, 1]
    assert np.all(g2 > -1e-4)


def test_legacy_matrix_roundtrip(breeding):
    L = to_legacy_matrix(breeding)
    assert L.shape == (449, 170)
    np.testing.assert_array_equal(L[:, 0::2], breeding.gl[:, :, 0])
    np.testing.assert_array_equal(L[:, 1::2], breeding.gl[:, :, 1])


def test_site_intersection(breeding):
    subset = read_beagle(str(BREEDING_SUBSET_BEAGLE))
    assert subset.n_sites == 357
    common = filter_sites_to_common(breeding, subset.site_names)
    assert common.n_sites == 357
    assert common.site_names == subset.site_names


def test_population_map():
    pm = read_ids(str(BREEDING_IDS))
    assert pm.n_inds == 85
    assert list(pm.pops) == ["Newfoundland", "Northeast", "Northwest", "South", "SouthDakota"]
    assert pm.pop_sizes.tolist() == [14, 20, 15, 23, 13]
    assert pm.membership.sum() == 85
    np.testing.assert_array_equal(pm.membership.argmax(axis=1), pm.pop_index)


def test_population_map_membership_order():
    pm = population_map(["a", "b", "c", "d"], ["z", "y", "z", "y"])
    assert list(pm.pops) == ["y", "z"]
    np.testing.assert_array_equal(pm.pop_index, [1, 0, 1, 0])
    np.testing.assert_array_equal(pm.members_of("y"), [1, 3])


def test_malformed_beagle(tmp_path):
    p = tmp_path / "bad.beagle.gz"
    with gzip.open(p, "wt") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\n")  # 2 GL cols: invalid
        f.write("s1\t0\t1\t0.5\t0.5\n")
    with pytest.raises(ValueError, match="Malformed Beagle header"):
        read_beagle(str(p))


def test_ragged_beagle_rows(tmp_path):
    p = tmp_path / "ragged.beagle.gz"
    with gzip.open(p, "wt") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\tInd0\n")
        f.write("s1\t0\t1\t0.5\t0.5\t0.0\t0.7\n")
    with pytest.raises(Exception):
        read_beagle(str(p))


def test_native_loader_matches_python():
    from wgsassign_jax._native import read_beagle_native
    from wgsassign_jax.io.beagle import _read_beagle_python

    native = read_beagle_native(str(BREEDING_BEAGLE))
    if native is None:
        pytest.skip("native loader unavailable (no toolchain)")
    py = _read_beagle_python(str(BREEDING_BEAGLE))
    np.testing.assert_array_equal(native.gl, py.gl)
    assert native.sample_names == py.sample_names
    assert native.site_names == py.site_names


def test_native_loader_malformed(tmp_path):
    from wgsassign_jax._native import read_beagle_native

    if read_beagle_native(str(BREEDING_BEAGLE)) is None:
        pytest.skip("native loader unavailable")
    p = tmp_path / "bad.beagle.gz"
    with gzip.open(p, "wt") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\tInd0\n")
        f.write("s1\t0\t1\t0.5\t0.5\n")  # short row
    with pytest.raises(ValueError, match="Malformed"):
        read_beagle_native(str(p))


def test_native_loader_plain_text(tmp_path):
    """zlib's gzopen reads uncompressed files transparently too."""
    from wgsassign_jax._native import read_beagle_native

    if read_beagle_native(str(BREEDING_BEAGLE)) is None:
        pytest.skip("native loader unavailable")
    p = tmp_path / "plain.beagle"
    with open(p, "w") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\tInd0\n")
        f.write("s1\t0\t1\t0.25\t0.5\t0.25\n")
        f.write("s2\t0\t1\t1\t0\t0\n")
    d = read_beagle_native(str(p))
    assert d.site_names == ["s1", "s2"]
    np.testing.assert_allclose(d.gl[:, 0, :], [[0.25, 0.5], [1.0, 0.0]])


def test_row_range_reading(breeding):
    from wgsassign_jax.io.beagle import read_beagle as rb

    part = rb(str(BREEDING_BEAGLE), row_range=(100, 140))
    assert part.n_sites == 40
    np.testing.assert_array_equal(part.gl, breeding.gl[100:140])
    assert part.site_names == breeding.site_names[100:140]
    # past-the-end clamps
    tail = rb(str(BREEDING_BEAGLE), row_range=(440, 500))
    assert tail.n_sites == 9


def test_native_row_range_matches_python():
    from wgsassign_jax._native import read_beagle_native
    from wgsassign_jax.io.beagle import _read_beagle_python

    native = read_beagle_native(str(BREEDING_BEAGLE), row_range=(100, 140))
    if native is None:
        pytest.skip("native loader unavailable (no toolchain)")
    py = _read_beagle_python(str(BREEDING_BEAGLE), row_range=(100, 140))
    np.testing.assert_array_equal(native.gl, py.gl)
    assert native.site_names == py.site_names
    # windows crossing the decompression chunk boundary / clamped at EOF
    tail = read_beagle_native(str(BREEDING_BEAGLE), row_range=(440, 500))
    assert tail.n_sites == 9
    empty = read_beagle_native(str(BREEDING_BEAGLE), row_range=(460, 500))
    assert empty.n_sites == 0 and empty.n_inds == 85


def test_beagle_dims():
    from wgsassign_jax.io.beagle import beagle_dims

    assert beagle_dims(str(BREEDING_BEAGLE)) == (449, 85)
    assert beagle_dims(str(BREEDING_BEAGLE), use_native=False) == (449, 85)


def test_beagle_dims_cache(tmp_path, monkeypatch):
    """The dims sidecar cache memoizes (m, n) per (path, size, mtime) and
    invalidates when the file changes — streamed ingest re-runs skip the
    full decompression scan pass."""
    import shutil

    from wgsassign_jax.io import beagle as bg

    cache = str(tmp_path / "cache" / "beagle_dims.json")
    monkeypatch.setattr(bg, "_dims_cache_path", lambda: cache)
    path = tmp_path / "dims.beagle.gz"
    shutil.copy(BREEDING_BEAGLE, path)
    assert bg.beagle_dims(str(path)) == (449, 85)
    # hit: scanning is bypassed entirely
    monkeypatch.setattr(
        bg, "_beagle_dims_scan",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("rescanned")),
    )
    assert bg.beagle_dims(str(path)) == (449, 85)
    # append a data row -> size/mtime change -> cache miss and rescan
    monkeypatch.undo()
    monkeypatch.setattr(bg, "_dims_cache_path", lambda: cache)
    import gzip as _gz

    with _gz.open(path, "rb") as f:
        text = f.read()
    row = text.rstrip(b"\n").rsplit(b"\n", 1)[-1]
    with _gz.open(path, "wb") as f:
        f.write(text + row + b"\n")
    assert bg.beagle_dims(str(path)) == (450, 85)


def test_disjoint_site_intersection_raises():
    from wgsassign_jax.io.beagle import site_intersection_masks

    with pytest.raises(ValueError, match="No common sites"):
        site_intersection_masks(["a_1", "a_2"], ["b_1", "b_2"])


def test_read_pop_names_single_row(tmp_path):
    from wgsassign_jax.io.ids import read_pop_names

    p = tmp_path / "one.pop_names.txt"
    p.write_text("OnlyPop\n")
    names = read_pop_names(str(p))
    assert names.shape == (1,)
    assert names[0] == "OnlyPop"
    p2 = tmp_path / "many.pop_names.txt"
    p2.write_text("A\nB\nC\n")
    assert read_pop_names(str(p2)).tolist() == ["A", "B", "C"]


def test_allele_depth_dim_validation(tmp_path):
    from wgsassign_jax.io.ad import read_allele_depths

    p = tmp_path / "ad.txt"
    np.savetxt(p, np.ones((5, 6), dtype=np.int32), fmt="%d")
    ad = read_allele_depths(str(p), n_sites=5, n_inds=3)
    assert ad.shape == (5, 6)
    with pytest.raises(ValueError, match="has 5 rows"):
        read_allele_depths(str(p), n_sites=7, n_inds=3)
    with pytest.raises(ValueError, match="covers 3 individuals"):
        read_allele_depths(str(p), n_sites=5, n_inds=4)
    odd = tmp_path / "odd.txt"
    np.savetxt(odd, np.ones((2, 5), dtype=np.int32), fmt="%d")
    with pytest.raises(ValueError, match="2 columns per individual"):
        read_allele_depths(str(odd))


def test_native_ad_reader_matches_loadtxt(tmp_path):
    """The native int tokenizer (ad_read) must reproduce np.loadtxt on
    plain and gzipped AD matrices, including negatives and blank lines."""
    from wgsassign_jax._native import _get_lib
    from wgsassign_jax.io.ad import read_allele_depths

    if _get_lib() is None:
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(42)
    ad = rng.integers(0, 300, size=(97, 10)).astype(np.int32)
    p = tmp_path / "ad.txt"
    np.savetxt(p, ad, fmt="%d", delimiter="\t")
    np.testing.assert_array_equal(read_allele_depths(str(p)), ad)

    import gzip

    pg = tmp_path / "ad_gz.txt"  # gzipped but WITHOUT a .gz suffix
    with open(p, "rb") as f, gzip.open(pg, "wb", compresslevel=1) as g:
        g.write(f.read())
    np.testing.assert_array_equal(read_allele_depths(str(pg)), ad)

    mixed = tmp_path / "mixed.txt"
    mixed.write_text("1 -2\n\n  3\t4  \n")
    np.testing.assert_array_equal(
        read_allele_depths(str(mixed)), [[1, -2], [3, 4]]
    )


def test_native_ad_reader_rejects_malformed(tmp_path):
    from wgsassign_jax._native import _get_lib, read_int_matrix_native

    if _get_lib() is None:
        pytest.skip("native library unavailable")
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1 2 3\n4 5\n")
    wide = tmp_path / "wide.txt"
    wide.write_text("1 2\n3 4 5\n")
    floaty = tmp_path / "floaty.txt"
    floaty.write_text("1 2\n3.5 4\n")
    for p, msg in [(ragged, "fewer columns"), (wide, "more columns"),
                   (floaty, "non-integer")]:
        with pytest.raises(ValueError, match=msg):
            read_int_matrix_native(str(p))
    with pytest.raises(FileNotFoundError):
        read_int_matrix_native(str(tmp_path / "missing.txt"))


def test_hashed_site_intersection_matches_string_masks():
    """The hash-based intersection (O(M)*8B host memory) must produce the
    exact keep masks of the string-set version on the bundled amre pair."""
    from conftest import BREEDING_BEAGLE, BREEDING_SUBSET_BEAGLE
    from wgsassign_jax.io.beagle import (
        scan_site_hashes,
        scan_site_names,
        site_intersection_masks,
        site_intersection_masks_hashed,
    )

    full_names = scan_site_names(str(BREEDING_BEAGLE))
    ds_names = scan_site_names(str(BREEDING_SUBSET_BEAGLE))
    kf_str, kd_str = site_intersection_masks(full_names, ds_names)
    h_full = scan_site_hashes(str(BREEDING_BEAGLE))
    h_ds = scan_site_hashes(str(BREEDING_SUBSET_BEAGLE))
    assert h_full.size == len(full_names) and h_ds.size == len(ds_names)
    kf_h, kd_h = site_intersection_masks_hashed(h_full, h_ds)
    np.testing.assert_array_equal(kf_h, kf_str)
    np.testing.assert_array_equal(kd_h, kd_str)


def test_hashed_site_intersection_errors():
    from wgsassign_jax.io.beagle import site_intersection_masks_hashed

    a = np.array([1, 2, 3], dtype=np.uint64)
    with pytest.raises(ValueError, match="disjoint"):
        site_intersection_masks_hashed(a, np.array([9], dtype=np.uint64))
    # order mismatch: common sites appear in a different order
    with pytest.raises(ValueError, match="do not match after"):
        site_intersection_masks_hashed(
            a, np.array([3, 1], dtype=np.uint64)
        )
