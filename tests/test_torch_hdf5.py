"""The port's HDF5 reader and writer (`gluefactory_tpu_torch/utils/hdf5.py`)
against h5py: files h5py writes read back bit for bit, files the port writes
read by h5py, and each variant the reader refuses named in its ValueError.
No JAX here."""

import h5py
import numpy as np
import pytest

from gluefactory_tpu_torch.utils import hdf5


def same(a, b):
    """Equal values, dtype and shape, bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


RNG = np.random.RandomState(0)
ARRAYS = {
    "f2": RNG.randn(7, 5).astype(np.float16),
    "f4": RNG.randn(3, 4, 5).astype(np.float32),
    "f8": RNG.randn(11).astype(np.float64),
    "i1": RNG.randint(-128, 127, (9,)).astype(np.int8),
    "i2": RNG.randint(-30000, 30000, (4, 3)).astype(np.int16),
    "i4": RNG.randint(-2**31, 2**31 - 1, (6,)).astype(np.int32),
    "i8": RNG.randint(-2**62, 2**62, (2, 2), dtype=np.int64),
    "u1": RNG.randint(0, 255, (5, 2)).astype(np.uint8),
    "u2": RNG.randint(0, 65535, (3,)).astype(np.uint16),
    "u4": RNG.randint(0, 2**32 - 1, (3,), dtype=np.uint64).astype(np.uint32),
    "u8": RNG.randint(0, 2**63, (3,), dtype=np.uint64),
    "be_f4": RNG.randn(4, 3).astype(">f4"),
    "be_f8": RNG.randn(5).astype(">f8"),
    "be_i4": RNG.randint(-1000, 1000, (6,)).astype(">i4"),
    "be_u2": RNG.randint(0, 65535, (6,)).astype(">u2"),
    "bool": RNG.rand(13) > 0.5,
    "scalar_f8": np.float64(2.5),
    "scalar_i4": np.int32(-7),
    "empty_f4": np.zeros((0,), np.float32),
    "empty_2d": np.zeros((3, 0), np.int16),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_reads_h5py_contiguous(tmp_path, name):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=ARRAYS[name])
    with h5py.File(path, "r") as f:
        ref = f[name][()]
    with hdf5.File(path, "r") as f:
        ds = f[name]
        assert ds.shape == ARRAYS[name].shape and ds.dtype == ref.dtype
        same(np.asarray(ds), np.asarray(ref))
        got = ds[()]
        assert type(got) is type(ref)
        same(got, ref)


CHUNKED = {
    # name: (array, create_dataset keywords)
    "plain": (RNG.randn(37, 23).astype(np.float32), {"chunks": (8, 5)}),
    "gzip1": (RNG.randn(37, 23).astype(np.float32), {"chunks": (8, 5), "compression": "gzip",
                                                     "compression_opts": 1}),
    "gzip9_shuffle": (RNG.randint(0, 1000, (50, 17)).astype(np.int32),
                      {"chunks": (16, 16), "compression": "gzip", "compression_opts": 9,
                       "shuffle": True}),
    "shuffle_only": (RNG.randn(40).astype(np.float64), {"chunks": (7,), "shuffle": True}),
    "fletcher32": (RNG.randn(30, 9).astype(np.float32), {"chunks": (8, 4), "fletcher32": True}),
    "all_filters": (RNG.randn(21, 13, 3).astype(">f4"),
                    {"chunks": (5, 4, 2), "compression": "gzip", "shuffle": True,
                     "fletcher32": True}),
    "bool_gzip": (RNG.rand(33, 7) > 0.3, {"chunks": (10, 3), "compression": "gzip"}),
    "edge_1d": (np.arange(1001, dtype=np.int16), {"chunks": (100,)}),
    "f2_gzip": (RNG.randn(64, 3).astype(np.float16), {"chunks": (10, 3), "compression": "gzip"}),
}


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_reads_h5py_chunked(tmp_path, name):
    arr, kw = CHUNKED[name]
    path = tmp_path / "k.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=arr, **kw)
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as g:
        same(np.asarray(f[name]), g[name][()])


def test_reads_h5py_unallocated_chunks_as_fill(tmp_path):
    path = tmp_path / "fill.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("a", shape=(20, 30), dtype=np.float32, chunks=(6, 7),
                             fillvalue=-3.25, compression="gzip")
        d[2:9, 11:15] = 1.5  # touches 4 of the 20 chunks
        f.create_dataset("z", shape=(10,), dtype=np.int64, chunks=(4,))  # none written
        f.create_dataset("c", shape=(4, 4), dtype=np.uint8, fillvalue=9)  # contiguous, unwritten
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as g:
        for k in ("a", "z", "c"):
            same(np.asarray(f[k]), g[k][()])
    assert np.asarray(hdf5.File(path)["a"])[0, 0] == -3.25


def test_reads_h5py_compact_layout(tmp_path):
    path = tmp_path / "compact.h5"
    arr = RNG.randn(5, 3).astype(np.float32)
    with h5py.File(path, "w") as f:
        space = h5py.h5s.create_simple(arr.shape)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dsid = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_FLOAT, space, dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
        dsid.close()
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as g:
        assert g["compact"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
        same(np.asarray(f["compact"]), g["compact"][()])


def test_reads_h5py_groups(tmp_path):
    """Nested groups, a group of 300 members (several SNODs under a
    two-level B-tree) and a 1000-member one, `in`, `keys()`, absolute and
    relative paths, a null dataspace."""
    path = tmp_path / "groups.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("a/b/c/deep", data=np.arange(3))
        for i in range(300):
            f.create_dataset(f"many/item{i:03d}", data=np.full(2, i, np.int32))
        big = f.create_group("big")
        for i in range(1000):
            big.create_group(f"img_{(i * 7919) % 1000}.jpg").create_dataset(
                "k", data=np.float32(i))
        f.create_dataset("null", data=h5py.Empty("f4"))
    with hdf5.File(path, "r") as f, h5py.File(path, "r") as g:
        assert f.keys() == list(g.keys())
        assert f["many"].keys() == list(g["many"].keys()) and len(f["many"]) == 300
        assert f["big"].keys() == list(g["big"].keys()) and len(f["big"]) == 1000
        for i in (0, 1, 150, 299):
            same(np.asarray(f[f"many/item{i:03d}"]), g[f"many/item{i:03d}"][()])
        for name in list(g["big"].keys())[::97]:
            same(np.asarray(f["big"][name]["k"]), g["big"][name]["k"][()])
        same(np.asarray(f["/a/b/c/deep"]), g["a/b/c/deep"][()])
        same(np.asarray(f["a"]["b/c"]["deep"]), g["a/b/c/deep"][()])
        assert "a/b/c" in f and "a/b/x" not in f and "deep" in f["a/b/c"]
        assert f["null"].shape is None and g["null"].shape is None
        with pytest.raises(KeyError):
            f["a/missing"]


@pytest.mark.parametrize("n_members", [1, 8, 9, 1000])
def test_h5py_reads_port_files(tmp_path, n_members):
    """The writer's groups (one SNOD, a full one, two, a 1000-member group
    under a two-level B-tree) and every dtype it writes, through h5py."""
    path = tmp_path / "w.h5"
    names = [f"Undistorted_SfM/0015/images/{(i * 7919) % 100003}.jpg" for i in range(n_members)]
    arrays = {k: v for k, v in ARRAYS.items()}
    with hdf5.File(path, "w") as f:
        for i, name in enumerate(names):
            grp = f.create_group(name)
            grp.create_dataset("keypoints", data=np.full((3, 2), i, np.float32))
            grp.create_dataset("valid", data=np.array([i % 2 == 0, True]))
        for k, v in arrays.items():
            f.create_dataset(f"types/{k}", data=v)
        f["scalar"] = np.float32(1.25)
        f.create_group("empty")
    with h5py.File(path, "r") as g:
        assert len(g["empty"]) == 0
        imgs = g["Undistorted_SfM/0015/images"]
        assert len(imgs) == n_members and sorted(imgs.keys()) == list(imgs.keys())
        for i, name in enumerate(names):
            same(g[name]["keypoints"][()], np.full((3, 2), i, np.float32))
            same(g[name]["valid"][()], np.array([i % 2 == 0, True]))
        for k, v in arrays.items():
            same(g[f"types/{k}"][()], v)
        assert g["scalar"][()] == np.float32(1.25)
    with hdf5.File(path, "r") as f:  # and the reader reads them back
        assert f["Undistorted_SfM/0015/images"].keys() == sorted(
            n.rsplit("/", 1)[1] for n in names)
        for k, v in arrays.items():
            same(np.asarray(f[f"types/{k}"]), v)


def test_writer_depth_file_bit_for_bit(tmp_path):
    """A MegaDepth depth file (`/depth`, 1200 x 1600 float32) each way."""
    depth = (RNG.rand(1200, 1600) * 50).astype(np.float32)
    with hdf5.File(tmp_path / "port.h5", "w") as f:
        f.create_dataset("/depth", data=depth)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        f.create_dataset("/depth", data=depth)
    with h5py.File(tmp_path / "port.h5", "r") as g:
        same(g["/depth"][()], depth)
    with hdf5.File(tmp_path / "h5py.h5", "r") as f:
        same(np.asarray(f["/depth"], np.float32), depth)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with hdf5.File(tmp_path / "r.h5", "w") as f:
        for bad in (np.array(["a", "b"]), np.zeros(2, np.complex64),
                    np.zeros(2, [("a", "f4"), ("b", "i4")])):
            with pytest.raises(ValueError, match="does not write"):
                f.create_dataset("x", data=bad)
        f.create_dataset("x", data=np.zeros(2))
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("x", data=np.zeros(2))


def _latest(f):
    f.create_dataset("x", data=np.zeros(3))


def _lzf(f):
    f.create_dataset("x", data=np.zeros((10, 10), np.float32), chunks=(5, 5), compression="lzf")


def _string(f):
    # fixed-length ASCII strings read as numpy bytes (tests/test_torch_export.py);
    # the UTF-8 character set is refused
    f.create_dataset("x", shape=(2,), dtype=h5py.string_dtype("utf-8", 3))[0] = b"abc"


def _vlen_string(f):
    f.create_dataset("x", data=["abc", "de"], dtype=h5py.string_dtype())


def _compound(f):
    f.create_dataset("x", data=np.zeros(3, [("a", "f4"), ("b", "i4")]))


def _track_order(f):
    f.create_group("g", track_order=True).create_dataset("x", data=np.zeros(2))


def _committed(f):
    f["t"] = np.dtype("f4")
    f.create_dataset("x", data=np.zeros(2, np.float32), dtype=f["t"])


def _scaleoffset(f):
    f.create_dataset("x", data=np.zeros((8, 8), np.int32), chunks=(4, 4), scaleoffset=0)


def _opaque(f):
    f.create_dataset("x", data=np.void(b"abcd"))


def _array_type(f):
    tid = h5py.h5t.array_create(h5py.h5t.NATIVE_FLOAT, (2,))
    h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,))).close()


REFUSED = {
    "latest": (_latest, {"libver": "latest"}, "superblock v[23]", "/x"),
    "lzf": (_lzf, {}, "lzf filter", "/x"),
    "string": (_string, {}, "string datatype", "/x"),
    "vlen_string": (_vlen_string, {}, "variable-length datatype", "/x"),
    "compound": (_compound, {}, "compound datatype", "/x"),
    # track_order gives a new-style group, whose header h5py writes as v2
    "track_order": (_track_order, {}, "object header v2|link messages", "/g/x"),
    "committed": (_committed, {}, "committed", "/x"),
    "scaleoffset": (_scaleoffset, {}, "scaleoffset filter", "/x"),
    "opaque": (_opaque, {}, "opaque datatype", "/x"),
    "array": (_array_type, {}, "array datatype", "/x"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_variants_name_themselves(tmp_path, name):
    make, kw, pattern, key = REFUSED[name]
    path = tmp_path / f"{name}.h5"
    with h5py.File(path, "w", **kw) as f:
        make(f)
    with pytest.raises(ValueError, match=pattern):
        with hdf5.File(path, "r") as f:
            np.asarray(f[key])


def test_fletcher32_checks_each_chunk(tmp_path):
    path = tmp_path / "bad.h5"
    arr = np.arange(64, dtype=np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=arr, chunks=(16,), fletcher32=True)
        offset = f["x"].id.get_chunk_info(1).byte_offset
    raw = bytearray(path.read_bytes())
    raw[offset + 3] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32"):
        with hdf5.File(path, "r") as f:
            np.asarray(f["x"])


def test_datasets_are_read_when_asked_and_across_threads(tmp_path):
    """Opening a file of many groups reads no data; threads share a file."""
    from concurrent.futures import ThreadPoolExecutor

    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        for i in range(64):
            f.create_dataset(f"g{i}/x", data=np.full((100, 10), i, np.float32))
    with hdf5.File(path, "r") as f:
        with ThreadPoolExecutor(4) as pool:
            sums = list(pool.map(lambda i: float(np.asarray(f[f"g{i}/x"]).sum()), range(64)))
    assert sums == [1000.0 * i for i in range(64)]


def _as_superblock_v1(raw: bytes) -> bytes:
    """A v0 file rewritten with a v1 superblock (4 more bytes: the
    indexed-storage K and a reserved field). The root group's object header,
    which follows the superblock, is copied to the end of the file to make
    room, and the superblock points to the copy."""
    import struct

    O, L = raw[13], raw[14]
    entry = 24 + 4 * O
    header = int.from_bytes(raw[entry + L:entry + L + O], "little")
    size = 16 + struct.unpack_from("<I", raw, header + 8)[0]
    copy_at = len(raw) + (-len(raw) % 8)
    tail = b"\0" * (copy_at - len(raw)) + raw[header:header + size]
    eof = copy_at + size
    sb = (raw[:8] + b"\x01" + raw[9:24] + struct.pack("<HH", 32, 0) + raw[24:24 + 2 * O]
          + eof.to_bytes(O, "little") + raw[24 + 3 * O:entry + L]
          + copy_at.to_bytes(O, "little") + raw[entry + L + O:entry + L + O + 24])
    assert header < len(sb) <= header + size
    return sb + raw[len(sb):] + tail


@pytest.mark.parametrize("sizes,variant", [((4, 4), "v1"), ((8, 4), "v0"), ((2, 2), "v1"),
                                           ((4, 8), "v0"), ((8, 8), "userblock")])
def test_reads_other_superblocks(tmp_path, sizes, variant):
    """Offsets and lengths of 2, 4 and 8 bytes, superblock v1 and a
    superblock after a 512-byte user block."""
    path = tmp_path / "sb.h5"
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(*sizes)
    if variant == "userblock":
        fcpl.set_userblock(512)
    arr = RNG.randn(9, 7).astype(np.float32)
    with h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        f.create_dataset("c", data=arr)
        f.create_dataset("k", data=arr, chunks=(4, 4), compression="gzip", shuffle=True)
        for i in range(40):
            f.create_dataset(f"g/{i}", data=np.int16(i))
    if variant == "v1":
        path.write_bytes(_as_superblock_v1(path.read_bytes()))
        with h5py.File(path, "r") as g:  # HDF5 reads the rewritten file too
            same(g["k"][()], arr)
    with hdf5.File(path, "r") as f:
        same(np.asarray(f["c"]), arr)
        same(np.asarray(f["k"]), arr)
        assert sorted(f["g"].keys(), key=int) == [str(i) for i in range(40)]
        assert [int(f[f"g/{i}"][()]) for i in range(40)] == list(range(40))


def test_reads_continuation_chunks(tmp_path):
    """Attributes added after creation overflow the first header chunk into
    continuation chunks; every message is found and the data read."""
    import struct

    path = tmp_path / "cont.h5"
    arr = RNG.randn(6, 4).astype(np.float32)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=arr)
        g = f.create_group("g")
        for i in range(40):
            d.attrs[f"a{i}"] = np.arange(25, dtype=np.float32) + i
            g.attrs[f"b{i}"] = np.arange(25, dtype=np.float64)
        g.create_dataset("y", data=arr[::-1])
    raw = path.read_bytes()
    with hdf5.File(path, "r") as f:
        reader = f._reader
        for name, addr in reader.members(reader.root).items():
            types = [t for t, _, _ in reader.header(addr)]
            assert types.count(0x0C) == 40, name  # all 40 attributes
            first = struct.unpack_from("<I", raw, addr + 8)[0]
            assert first < 40 * 100  # so most of them lie in continuation chunks
        same(np.asarray(f["x"]), arr)
        same(np.asarray(f["g/y"]), arr[::-1])
