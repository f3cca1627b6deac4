"""The port's HDF5 reader against h5py, and its writer read back by h5py
(CPU).

* Files h5py writes in its default ("earliest") format: every datatype
  the reader covers (signed and unsigned integers of 1-8 bytes, IEEE
  floats of 2, 4 and 8 bytes in both byte orders, fixed-length strings,
  variable-length strings and sequences), scalar, empty, compact and
  never-written datasets, a group of 300 members (h5py's B-tree: a level-1
  root over three level-0 nodes of symbol-table nodes), numeric, string and variable-length string
  attributes (0-d and 1-d, ASCII and UTF-8, empty): the same arrays,
  values and member order as h5py, exactly.
* A file Keras writes (``model.save("m.h5")``): every group, dataset and
  attribute equal to h5py's reading.
* What it does not read raises ``NotImplementedError`` naming the
  feature: a chunked and a gzip-filtered dataset, a ``libver="latest"``
  file (superblock version 3).
* ``testing/keras_builder.H5Writer``'s output read by h5py, array for
  array and attribute for attribute, with groups of 0, 7, 8, 9, 300 and
  600 members (SNOD and B-tree boundaries, two B-tree levels), and
  variable-length strings over several global heap collections.

h5py is needed to write and read the reference files; the port never
imports it.
"""

import io

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.imports import hdf5
from deeplearning4j_tpu_torch.testing import keras_builder as kb

DTYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "<f2", "<f4",
          "<f8", ">f2", ">f4", ">f8", ">i2", ">i4", ">u8"]


def _same(a, b):
    """h5py's value ``a`` and the port's ``b``: equal values, the same
    type, the same dtype up to byte order."""
    if isinstance(a, np.ndarray) and a.dtype == object:
        return (isinstance(b, np.ndarray) and b.dtype == object
                and a.shape == b.shape
                and all(_same(x, y) for x, y in zip(a.ravel(), b.ravel())))
    if isinstance(a, (str, bytes)):
        return type(a) is type(b) and a == b
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.newbyteorder("=")
            == b.dtype.newbyteorder("=") and np.array_equal(a, b))


@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "all.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for dt in DTYPES:
            f.create_dataset(f"t/{dt}", data=(rng.standard_normal((3, 4))
                                             * 50).astype(dt))
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("empty", shape=(0, 3), dtype="f4")
        f.create_dataset("unwritten", shape=(2, 2), dtype="f8")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE,
                             h5py.h5s.create_simple((5,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype="i4"))
        f.create_dataset("fixed_str", data=np.array([b"ab", b"cde"], "S3"))
        f.create_dataset("vlen_str", data=["x", "héllo", "yz"],
                         dtype=h5py.string_dtype())
        f.create_dataset("vlen_seq", dtype=h5py.vlen_dtype("i4"), data=[
            np.arange(3, dtype="i4"), np.arange(5, dtype="i4")])
        g = f.create_group("big")
        for i in range(300):
            g.create_dataset(f"x{i:03d}", data=np.full((2,), i, "f4"))
        g.attrs["scale"] = 1.5
        f.create_group("a/b/c").create_dataset("leaf", data=np.eye(3))
        f.attrs["ascii"] = np.array(b"hello", dtype=h5py.string_dtype(
            "ascii"))
        f.attrs["utf8"] = "héllo"
        f.attrs["strs"] = np.array(["a", "bb", "ccc"],
                                   dtype=h5py.string_dtype())
        f.attrs["fixed"] = np.bytes_(b"fixed")
        f.attrs["fixed_arr"] = np.array([b"a", b"bcd"])
        f.attrs["int"] = 3
        f.attrs["floats"] = np.arange(4.0)
        f.attrs["empty"] = np.zeros((0,))
        f.attrs["matrix"] = np.arange(6, dtype=">i4").reshape(2, 3)
        f.create_dataset("chunked", data=np.arange(100.0), chunks=(10,))
        f.create_dataset("gzip", data=np.arange(100.0), compression="gzip")
    return path


@pytest.mark.parametrize("dt", DTYPES)
def test_numeric_dataset_matches_h5py(h5file, dt):
    with h5py.File(h5file, "r") as H, hdf5.File(h5file) as M:
        want, got = H[f"t/{dt}"][()], M[f"t/{dt}"][()]
        assert _same(want, got)
        assert got.dtype.byteorder in "=|" or got.dtype.isnative
        assert M[f"t/{dt}"].shape == H[f"t/{dt}"].shape


@pytest.mark.parametrize("name", ["scalar", "empty", "unwritten", "compact",
                                  "fixed_str", "vlen_seq", "a/b/c/leaf"])
def test_special_dataset_matches_h5py(h5file, name):
    with h5py.File(h5file, "r") as H, hdf5.File(h5file) as M:
        assert _same(H[name][()], M[name][()])
        assert _same(H[name][()], np.asarray(M[name])) or name == "scalar"


def test_vlen_string_dataset(h5file):
    with h5py.File(h5file, "r") as H, hdf5.File(h5file) as M:
        want = np.array([s.decode() for s in H["vlen_str"][()]],
                        dtype=object)
        assert _same(want, M["vlen_str"][()])


@pytest.mark.parametrize("name", ["ascii", "utf8", "strs", "fixed",
                                  "fixed_arr", "int", "floats", "empty",
                                  "matrix"])
def test_attribute_matches_h5py(h5file, name):
    with h5py.File(h5file, "r") as H, hdf5.File(h5file) as M:
        assert _same(H.attrs[name], M.attrs[name]), (H.attrs[name],
                                                     M.attrs[name])


def test_large_group_btree(h5file):
    """300 members: h5py's B-tree has a level-1 root over three level-0
    nodes; the members, their order and lookups."""
    with h5py.File(h5file, "r") as H, hdf5.File(h5file) as M:
        assert list(M["big"].keys()) == list(H["big"].keys())
        assert len(M["big"]) == 300
        assert list(M) == list(H)
        for i in (0, 7, 8, 150, 299):
            assert np.array_equal(M[f"big/x{i:03d}"][()],
                                  H[f"big/x{i:03d}"][()])
        assert "big/x123" in M and "big/x300" not in M
        assert M["big"].attrs["scale"] == 1.5
        assert isinstance(M["big"], hdf5.Group)
        assert isinstance(M["big/x001"], hdf5.Dataset)
        with pytest.raises(KeyError):
            M["big/missing"]


@pytest.mark.parametrize("name,feature", [("chunked", "chunked"),
                                          ("gzip", "filtered")])
def test_unsupported_layout_raises(h5file, name, feature):
    with hdf5.File(h5file) as M:
        with pytest.raises(NotImplementedError, match=feature) as e:
            np.asarray(M[name])
        assert name in str(e.value)


def test_latest_format_raises(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("a", data=np.arange(3))
    with pytest.raises(NotImplementedError, match="superblock version 3"):
        hdf5.File(path)


def test_bytes_and_stream_sources(h5file):
    data = open(h5file, "rb").read()
    for src in (data, io.BytesIO(data)):
        with hdf5.File(src) as M:
            assert np.array_equal(M["t/<f4"][()],
                                  h5py.File(h5file, "r")["t/<f4"][()])


def test_keras_written_file(tmp_path):
    """Every object of the file Keras writes equals h5py's reading."""
    keras = pytest.importorskip("keras")
    model = keras.Sequential([keras.Input((6,)),
                              keras.layers.Dense(4, activation="relu"),
                              keras.layers.Dropout(0.1),
                              keras.layers.Dense(2)])
    path = str(tmp_path / "m.h5")
    model.save(path)
    seen = []
    with h5py.File(path, "r") as H, hdf5.File(path) as M:
        def visit(name, obj):
            seen.append(name)
            got = M[name]
            for k, v in obj.attrs.items():
                assert _same(v, got.attrs[k]), (name, k)
            if isinstance(obj, h5py.Dataset):
                assert _same(obj[()], got[()]), name
            else:
                assert list(obj.keys()) == list(got.keys()), name

        H.visititems(visit)
        for k, v in H.attrs.items():
            assert _same(v, M.attrs[k]), k
    assert any(n.endswith("kernel") for n in seen)


def _writer_tree(counts):
    rng = np.random.default_rng(1)
    w = kb.H5Writer()
    arrays, attrs = {}, {}
    for n in counts:
        w.group(f"g{n}")
        for i in range(n):
            a = rng.standard_normal((2, 3)).astype("f4")
            arrays[f"g{n}/m{i:04d}"] = a
            w.dataset(f"g{n}/m{i:04d}", a)
    for dt in ("i1", "u2", "i4", "i8", "f2", "f4", "f8", ">f4"):
        a = (rng.standard_normal(5) * 9).astype(dt)
        key = "t/" + dt.replace(">", "be")
        arrays[key] = a
        w.dataset(key, a)
    arrays["scalar"] = np.float32(2.0)
    w.dataset("scalar", arrays["scalar"])
    arrays["empty"] = np.zeros((0, 4), "f4")
    w.dataset("empty", arrays["empty"])
    big = "x" * 70000 + "é"  # a collection of its own
    attrs["/"] = {"config": big, "version": "3.13.1"}
    names = [f"layer_{i:04d}/a_long_variable_name".encode()
             for i in range(3000)]  # ~144 KB of heap: three collections
    attrs["t"] = {"names": names, "n": np.int64(3),
                  "empty": np.zeros((0,)), "vec": np.arange(3.0)}
    for path, kv in attrs.items():
        for k, v in kv.items():
            w.attr(path, k, v)
    return w, arrays, attrs


def test_writer_read_by_h5py():
    counts = (0, 7, 8, 9, 300, 600)
    w, arrays, attrs = _writer_tree(counts)
    data = w.tobytes()
    with h5py.File(io.BytesIO(data), "r") as H, hdf5.File(data) as M:
        for n in counts:
            want = [f"m{i:04d}" for i in range(n)]
            assert list(H[f"g{n}"].keys()) == want
            assert list(M[f"g{n}"].keys()) == want
        for key, a in arrays.items():
            assert np.array_equal(H[key][()], a), key
            assert np.array_equal(M[key][()], a), key
            assert H[key].shape == np.shape(a)
        assert H.attrs["config"] == attrs["/"]["config"]
        assert M.attrs["config"] == attrs["/"]["config"]
        assert list(H["t"].attrs["names"]) == [s.decode() for s in
                                               attrs["t"]["names"]]
        assert list(M["t"].attrs["names"]) == list(H["t"].attrs["names"])
        assert H["t"].attrs["n"] == 3 and M["t"].attrs["n"] == 3
        assert H["t"].attrs["empty"].shape == (0,)
        assert np.array_equal(H["t"].attrs["vec"], np.arange(3.0))
        for k in H["t"].attrs:
            assert _same(H["t"].attrs[k], M["t"].attrs[k]), k


def test_keras_builder_file_read_by_h5py():
    """The builder's Keras file: h5py reads the same weights the builder
    returns, under the ``weight_names`` it lists."""
    data, arrays = kb.conv1d_keras_h5(None, vocab=50, seq=12)
    with h5py.File(io.BytesIO(data), "r") as H:
        assert H.attrs["keras_version"] == kb.KERAS_VERSION
        layer_names = list(H["model_weights"].attrs["layer_names"])
        assert layer_names == list(arrays)
        for name, arrs in arrays.items():
            g = H["model_weights"][name]
            names = list(g.attrs["weight_names"])
            assert len(names) == len(arrs)
            for n, a in zip(names, arrs):
                assert np.array_equal(g[n][()], a)
