"""The port's HDF5 codec (fava_tpu_torch/io/h5lite.py) against h5py.

Files written by h5lite must read back identically in h5py, and files
written by h5py (with its default, earliest-format settings, as FLASH
and fava_tpu write them) must read identically in h5lite: flat files,
nested groups, and files one of them appended to. What h5lite does not
support raises NotImplementedError. Comparisons are exact.
"""

import h5py
import numpy as np
import pytest

from fava_tpu_torch.io import h5lite

PARAM = [("name", "S256"), ("value", "<f8")]
INT_PARAM = [("name", "S256"), ("value", "<i4")]
STR_PARAM = [("name", "S256"), ("value", "S256")]


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "dens": rng.random((3, 4, 5, 6)).astype("<f4"),
        "velx": rng.standard_normal((2, 3, 4)),
        "real scalars": np.array(
            [(f"{k:<256s}".encode(), v) for k, v in {"time": 1.5, "dt": 1e-3}.items()], dtype=PARAM
        ),
        "integer scalars": np.array([(b"nxb", 8), (b"nyb", -3)], dtype=INT_PARAM),
        "logical scalars": np.array([], dtype=INT_PARAM),
        "string scalars": np.array([(b"geometry", b"cartesian")], dtype=STR_PARAM),
        "unknown names": np.array([[b"dens"], [b"velx"]], dtype="S4"),
        "gid": -np.ones((3, 15), dtype="<i4"),
        "refine level": np.arange(7, dtype="<i8"),
        "bflags": np.zeros((0, 1), dtype="<i4"),
    }


def _assert_same(got, ref, key):
    assert got.dtype == ref.dtype and got.shape == ref.shape, key
    assert np.array_equal(got, ref), key


def test_h5py_reads_what_h5lite_writes(tmp_path):
    arrays = _arrays()
    with h5lite.File(tmp_path / "a.h5", "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        assert sorted(f) == sorted(arrays) and "dens" in f
    with h5py.File(tmp_path / "a.h5", "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            _assert_same(f[k][()], v, k)


@pytest.mark.parametrize("extra", [0, 40])
def test_h5lite_reads_what_h5py_writes(tmp_path, extra):
    """With 40 more datasets the root group spans several symbol nodes
    (h5py's leaf K is 4), so the B-tree walk is exercised."""
    arrays = _arrays()
    arrays.update({f"extra{i:02d}": np.arange(i + 1, dtype="<f8") for i in range(extra)})
    with h5py.File(tmp_path / "b.h5", "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    with h5lite.File(tmp_path / "b.h5") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            assert f[k].shape == v.shape and f[k].dtype == v.dtype
            _assert_same(f[k][()], v, k)


def test_create_dataset_converts_to_the_requested_dtype(tmp_path):
    data = np.linspace(0.0, 1.0, 24).reshape(2, 3, 4)
    with h5lite.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("f32", data=np.swapaxes(data, -1, -3), dtype="<f4")
        f.create_dataset("i32", data=[[1, 2], [3, 4]], dtype="<i4")
    with h5py.File(tmp_path / "c.h5") as f:
        _assert_same(f["f32"][()], np.ascontiguousarray(np.swapaxes(data, -1, -3)).astype("<f4"), "f32")
        _assert_same(f["i32"][()], np.array([[1, 2], [3, 4]], dtype="<i4"), "i32")


def test_h5py_scalars_and_compact_layout_read(tmp_path):
    with h5py.File(tmp_path / "d.h5", "w") as f:
        f.create_dataset("scalar", data=np.float64(2.5))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((4,))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype="<i4")
        )
    with h5lite.File(tmp_path / "d.h5") as f:
        assert f["scalar"][()] == 2.5 and f["scalar"].shape == ()
        _assert_same(f["compact"][()], np.arange(4, dtype="<i4"), "compact")


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda f: f.create_dataset("x", data=np.ones((8, 8)), chunks=(4, 4)), "chunked"),
        (lambda f: f.create_dataset("x", data=np.ones((8, 8)), compression="gzip"), "filtered"),
        # Creation order tracking gives a group new-style link storage.
        (lambda f: f.create_group("g", track_order=True).create_dataset("x", data=np.ones(3)),
         "nested group"),
    ],
)
def test_unsupported_features_raise(tmp_path, make, match):
    with h5py.File(tmp_path / "e.h5", "w") as f:
        make(f)
    with pytest.raises(NotImplementedError, match=match):
        with h5lite.File(tmp_path / "e.h5") as f:
            (name,) = f.keys()
            f[name][()]


def test_newer_file_formats_and_non_hdf5_files_raise(tmp_path):
    with h5py.File(tmp_path / "f.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(3))
    with pytest.raises(NotImplementedError, match="superblock version"):
        h5lite.File(tmp_path / "f.h5")
    (tmp_path / "g.h5").write_bytes(b"not an hdf5 file at all" * 4)
    with pytest.raises(OSError, match="not an HDF5 file"):
        h5lite.File(tmp_path / "g.h5")


def test_writer_refuses_what_it_cannot_encode(tmp_path):
    with h5lite.File(tmp_path / "h.h5", "w") as f:
        with pytest.raises(NotImplementedError, match="dtype"):
            f.create_dataset("b", data=np.array([True, False]))
        f.create_dataset("x", data=np.ones(2))
        with pytest.raises(ValueError, match="cannot create"):
            f.create_dataset("x", data=np.ones(2))
    with h5py.File(tmp_path / "h.h5") as f:
        assert list(f.keys()) == ["x"]


def _nested():
    rng = np.random.default_rng(1)
    return {
        "top": np.arange(4.0),
        "scalar": np.float64(2.5),
        "spectra/k": np.arange(7.0),
        "spectra/dens/power": rng.random((3, 5)).astype("<f4"),
        "spectra/empty": None,  # an empty group
        "pdf/label": np.array([b"dens", b"velx"]),
        "pdf/counts": rng.integers(0, 9, (4, 3)),
        **{f"many/m{i:02d}": np.full(2, i, dtype="<i4") for i in range(30)},
    }


def _write(f, tree):
    for path, value in tree.items():
        *groups, name = path.split("/")
        node = f
        for g in groups:
            node = node[g] if g in node else node.create_group(g)
        if value is None:
            node.create_group(name)
        else:
            node.create_dataset(name, data=value)


def _read(f, tree):
    for path, value in tree.items():
        assert path in f, path
        if value is not None:
            _assert_same(f[path][()], np.asarray(value), path)


@pytest.mark.parametrize("writer,reader", [(h5lite, h5py), (h5py, h5lite)])
def test_nested_groups_read_back_both_ways(tmp_path, writer, reader):
    """30 members in one group span several of h5py's symbol nodes."""
    tree = _nested()
    with writer.File(tmp_path / "n.h5", "w") as f:
        _write(f, tree)
    with reader.File(tmp_path / "n.h5", "r") as f:
        _read(f, tree)
        assert sorted(f["spectra"].keys()) == ["dens", "empty", "k"]
        assert list(f["spectra/empty"].keys()) == []
        assert "spectra/dens/power" in f and "spectra/velx" not in f and "top/x" not in f


@pytest.mark.parametrize("first,second", [(h5lite, h5py), (h5py, h5lite), (h5lite, h5lite)])
def test_append_replaces_and_keeps_both_ways(tmp_path, first, second):
    """One writes the file, the other appends to it: a replaced dataset,
    a deleted one, a new nested member; the rest kept."""
    tree = _nested()
    with first.File(tmp_path / "a.h5", "w") as f:
        _write(f, tree)
    with second.File(tmp_path / "a.h5", "a") as f:
        del f["spectra"]["k"]
        f["spectra"].create_dataset("k", data=np.arange(3))
        del f["top"]
        f["pdf"].create_group("more").create_dataset("x", data=np.ones(2))
    tree.update({"spectra/k": np.arange(3), "pdf/more/x": np.ones(2)})
    del tree["top"]
    for reader in (h5py, h5lite):
        with reader.File(tmp_path / "a.h5", "r") as f:
            _read(f, tree)
            assert "top" not in f
    assert not (tmp_path / "a.h5.tmp").exists()


def test_scalars_keep_their_shape(tmp_path):
    """A 0-d array is a scalar dataset (h5lite once wrote it as shape (1,))."""
    with h5lite.File(tmp_path / "s.h5", "w") as f:
        f.create_dataset("s", data=np.float64(1.25))
        f.create_dataset("i", data=7)
    with h5py.File(tmp_path / "s.h5") as f:
        assert f["s"].shape == () and f["s"][()] == 1.25
        assert f["i"].shape == () and f["i"][()] == 7
    with h5lite.File(tmp_path / "s.h5") as f:
        assert f["s"].shape == () and f["s"][()] == 1.25


def test_append_creates_a_missing_file_and_names_are_checked(tmp_path):
    with h5lite.File(tmp_path / "new.h5", "a") as f:
        g = f.create_group("g")
        with pytest.raises(ValueError, match="cannot create"):
            f.create_group("g")
        with pytest.raises(ValueError, match="cannot create"):
            g.create_dataset("a/b", data=1.0)
        g.create_dataset("x", data=[1, 2])
    with h5py.File(tmp_path / "new.h5") as f:
        np.testing.assert_array_equal(f["g/x"][()], [1, 2])
    with h5lite.File(tmp_path / "new.h5") as f:
        with pytest.raises(ValueError, match="mode 'w' or 'a'"):
            f.create_dataset("y", data=1.0)
        with pytest.raises(KeyError):
            f["g/x/deeper"]
