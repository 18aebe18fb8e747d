"""The port's HDF5 reader and writer (``tpucap_torch.checkpoint.hdf5``)
against h5py, on the CPU; no jax and no TensorFlow.

Files h5py writes (its default format, what Keras's ``.h5`` files are) are
read by the port: every dataset and attribute equal to h5py's reading,
exactly (dtype, shape and bits; strings as h5py returns them). Files the
port writes are read back by h5py, every array and attribute equal. Each
feature outside the subset raises a ``ValueError`` that names it.
"""

import struct

import h5py
import numpy as np
import pytest

from tpucap_torch.checkpoint import hdf5

DTYPES = ["<f2", "<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8"]
SHAPES = [(), (0,), (7,), (3, 5), (2, 3, 4), (2, 1, 3, 2)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


def _same(got, want):
    """h5py's reading and the port's: equal in type, dtype, shape and bits."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype.kind == "O":
            assert got.tolist() == want.tolist()
        else:
            assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want), (type(got), type(want))
        assert got == want or (got != got and want != want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_h5py_datasets(tmp_path, dtype, shape):
    path = tmp_path / "d.h5"
    want = _array(dtype, shape)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=want)
        f["y"] = _array(dtype, shape, seed=1)
    with hdf5.File(path) as f:
        ds = f["x"]
        assert ds.shape == shape and ds.dtype == np.dtype(dtype)
        got = ds.read()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert np.asarray(f["/y"]).tobytes() == _array(dtype, shape, seed=1).tobytes()


ATTRS = {
    "vlen_str": "caption 'model' — ünïcode",
    "vlen_ascii_bytes": b"tensorflow",
    "vlen_str_list": ["token_ids", "image_features", "lstm_0"],
    "vlen_bytes_list": [b"a/kernel:0", b"a/bias:0"],
    "fixed_bytes": np.bytes_(b"fixed"),
    "fixed_array": np.array([b"conv1", b"bn_conv1", b"x"]),
    "empty_list": [],
    "int_scalar": 7,
    "float_scalar": 0.5,
    "f32_array": np.arange(6, dtype=np.float32).reshape(2, 3),
    "i64_empty": np.zeros((0,), np.int64),
    "long_vlen": "x" * 100_000,
}


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_reads_h5py_attributes(tmp_path, name):
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        f.attrs[name] = ATTRS[name]
        f.create_group("g").attrs[name] = ATTRS[name]
        f.create_dataset("d", data=np.ones(2)).attrs[name] = ATTRS[name]
    with h5py.File(path, "r") as f:
        want = [f.attrs[name], f["g"].attrs[name], f["d"].attrs[name]]
    with hdf5.File(path) as f:
        got = [f.attrs[name], f["g"].attrs[name], f["d"].attrs[name]]
    for g, w in zip(got, want):
        _same(g, w)


def _tree(n_members):
    rng = np.random.default_rng(n_members)
    return {f"m{i:04d}/{'w' if i % 2 else 'b'}:0": rng.normal(size=(i % 4, 2)).astype(np.float32)
            for i in range(n_members)}


@pytest.mark.parametrize("n_members", [0, 1, 8, 9, 33, 300, 1000])
def test_reads_h5py_nested_and_large_groups(tmp_path, n_members):
    """Groups of one SNOD, of several, and of more than one B-tree leaf node
    holds (h5py splits them into internal nodes)."""
    path = tmp_path / "g.h5"
    tree = _tree(n_members)
    with h5py.File(path, "w") as f:
        top = f.create_group("model_weights")
        for k, v in tree.items():
            top.create_dataset(f"outer/{k}", data=v)
        top.create_group("outer/empty")
    with hdf5.File(path) as f:
        outer = f["model_weights"]["outer"]
        assert len(outer) == n_members + 1
        assert outer.keys() == sorted(list({k.split("/")[0] for k in tree}) + ["empty"])
        for k, v in tree.items():
            got = f[f"model_weights/outer/{k}"].read()
            assert got.dtype == v.dtype and got.shape == v.shape and got.tobytes() == v.tobytes()
        assert len(f["model_weights/outer/empty"]) == 0
        assert "model_weights/outer/absent" not in f


def _first_block_types(path, name):
    """The message types in the first block of an object's header."""
    with h5py.File(path, "r") as f:
        addr = h5py.h5o.get_info(f[name].id).addr
    raw = open(path, "rb").read()
    size = struct.unpack_from("<I", raw, addr + 8)[0]
    p, types = addr + 16, []
    while p < addr + 16 + size:
        mtype, msize = struct.unpack_from("<HH", raw, p)
        types.append(mtype)
        p += 8 + msize
    return types


@pytest.mark.parametrize("n_attrs", [40, 200])
def test_reads_headers_with_continuation_blocks(tmp_path, n_attrs):
    path = tmp_path / "c.h5"
    want = {f"attr_{i:03d}": np.full(i % 7 + 1, i, np.int32) for i in range(n_attrs)}
    with h5py.File(path, "w") as f:
        g = f.create_group("g")
        for k, v in want.items():
            g.attrs[k] = v
            g.attrs[k + "_s"] = f"value {k}"
    assert 0x10 in _first_block_types(path, "g")  # a continuation message
    with hdf5.File(path) as f:
        got = f["g"].attrs
    assert len(got) == 2 * n_attrs
    for k, v in want.items():
        _same(got[k], v)
        assert got[k + "_s"] == f"value {k}"


def _chunked(f):
    f.create_dataset("x", data=np.ones((4, 4)), chunks=(2, 2))


def _gzip(f):
    f.create_dataset("x", data=np.ones((4, 4)), compression="gzip")


def _big_endian(f):
    f.create_dataset("x", data=np.ones(3, dtype=">f4"))


def _compound(f):
    f.create_dataset("x", data=np.zeros(2, dtype=[("a", "<i4"), ("b", "<f4")]))


def _vlen_ints(f):
    dt = h5py.vlen_dtype(np.int32)
    ds = f.create_dataset("x", (2,), dtype=dt)
    ds[0], ds[1] = [1, 2], [3]


def _track_order(f):
    f.create_group("x", track_order=True).create_group("y")


def _dense_attrs(f):
    ds = f.create_dataset("x", data=np.ones(2), track_order=True)
    for i in range(12):  # more than the 8 a compact header holds
        ds.attrs[f"a{i}"] = i


REFUSED = [
    ("chunked", {}, _chunked, "chunked dataset"),
    ("gzip", {}, _gzip, "filtered dataset"),
    ("latest", {"libver": "latest"}, lambda f: f.create_group("x"), "superblock version 3"),
    ("v108", {"libver": ("v108", "v108")}, lambda f: f.create_group("x"), "superblock version 2"),
    ("big_endian", {}, _big_endian, "big-endian datatype"),
    ("compound", {}, _compound, "datatype class 6 \\(compound\\)"),
    ("vlen_sequence", {}, _vlen_ints, "variable-length sequence"),
    ("new_style_group", {}, _track_order, "new-style group"),
    ("dense_attributes", {}, _dense_attrs, "dense attribute storage"),
]


@pytest.mark.parametrize("case,kw,make,match", REFUSED, ids=[r[0] for r in REFUSED])
def test_refuses_features_outside_the_subset(tmp_path, case, kw, make, match):
    path = tmp_path / f"{case}.h5"
    with h5py.File(path, "w", **kw) as f:
        make(f)
    with pytest.raises(ValueError, match=match):
        with hdf5.File(path) as f:
            obj = f["x"]
            obj.attrs  # noqa: B018
            if isinstance(obj, hdf5.Dataset):
                obj.read()
            else:
                obj.keys()


def test_refuses_a_file_that_is_not_hdf5(tmp_path):
    path = tmp_path / "no.h5"
    path.write_bytes(b"not an HDF5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(path)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES + ["S5", ">f4"])
def test_h5py_reads_what_the_port_writes(tmp_path, dtype, shape):
    path = tmp_path / "w.h5"
    want = (
        np.array([b"ab", b"cdefg", b""] * 40, dtype="S5")[: int(np.prod(shape))].reshape(shape)
        if dtype == "S5"
        else _array(dtype, shape)
    )
    hdf5.write(path, hdf5.WGroup(members={"x": want, "g": hdf5.WGroup(members={"y": want})}))
    with h5py.File(path, "r") as f:
        for name in ("x", "g/y"):
            got = f[name][()]
            assert got.shape == want.shape
            assert got.dtype == want.dtype.newbyteorder("<") or dtype == "S5"
            np.testing.assert_array_equal(got, want)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["g/y"].read(), want)


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_h5py_reads_attributes_the_port_writes(tmp_path, name):
    path = tmp_path / "w.h5"
    value = ATTRS[name]
    hdf5.write(path, hdf5.WGroup(
        attrs={name: value},
        members={"g": hdf5.WGroup(attrs={name: value}), "d": np.ones(3, np.float32)},
    ))
    ref = tmp_path / "ref.h5"
    with h5py.File(ref, "w") as f:
        f.attrs[name] = value
    with h5py.File(ref, "r") as f:
        want = f.attrs[name]
    with h5py.File(path, "r") as f:
        _same(f.attrs[name], want)
        _same(f["g"].attrs[name], want)
    with hdf5.File(path) as f:
        _same(f.attrs[name], want)


@pytest.mark.parametrize("n_members", [0, 9, 33, 300, 1000])
def test_h5py_reads_large_groups_the_port_writes(tmp_path, n_members):
    """One SNOD holds 8 entries and one B-tree node 32 SNODs: larger groups
    take internal B-tree levels."""
    path = tmp_path / "w.h5"
    tree = _tree(n_members)
    root = hdf5.WGroup()
    outer = root.members.setdefault("outer", hdf5.WGroup(attrs={"n": np.int64(n_members)}))
    for k, v in tree.items():
        group, leaf = k.split("/")
        outer.members.setdefault(group, hdf5.WGroup()).members[leaf] = v
    hdf5.write(path, root)
    with h5py.File(path, "r") as f:
        assert len(f["outer"]) == len({k.split("/")[0] for k in tree})
        assert f["outer"].attrs["n"] == n_members
        for k, v in tree.items():
            np.testing.assert_array_equal(f[f"outer/{k}"][()], v)
            assert f[f"outer/{k}"].dtype == np.float32
    with hdf5.File(path) as f:
        for k, v in tree.items():
            assert f[f"outer/{k}"].read().tobytes() == v.tobytes()


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        hdf5.write(tmp_path / "c.h5", hdf5.WGroup(members={"x": np.zeros(2, np.complex64)}))
    with pytest.raises(ValueError, match="64 KiB"):
        hdf5.write(tmp_path / "a.h5", hdf5.WGroup(attrs={"a": np.zeros(20_000, np.float32)}))
