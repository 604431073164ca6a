"""An HDF5 reader and writer of the port's own (numpy, `zlib`, `struct`).

It serves the subset of h5py that the data pipeline uses: `File(path, "r")`
as a context manager, `f[path]` through nested groups, `keys()`, `in`,
`np.asarray(ds)`, `ds[()]`, `shape` and `dtype`; and `File(path, "w")` with
`create_group` / `create_dataset(name, data=...)` (intermediate groups made
as needed).

Reading covers what h5py writes by default (`libver="earliest"`):
superblock v0 / v1 with 2-, 4- or 8-byte offsets and lengths; object header
v1 with its continuation messages; symbol-table groups (a v1 B-tree of type 0
over `SNOD` nodes, names in the local heap); dataspace messages v1 / v2
(scalar, simple, null); fixed-point and IEEE float types of 1 to 8 bytes in
either byte order, and h5py's bool (an enum over int8, FALSE = 0, TRUE = 1)
read back as `bool`; data layout v3, compact, contiguous or chunked (a v1
B-tree of type 1; edge chunks cropped, unallocated chunks the fill value);
filters deflate (1), shuffle (2) and fletcher32 (3), each chunk's filter mask
honoured. A dataset's bytes are read when it is asked for, from a read-only
`mmap` of the file (safe to share between threads). Anything else raises
`ValueError` naming what was found: superblock v2 / v3 (`libver="latest"`),
object header v2, link-message groups, layouts other than v3 (and the
virtual class), filters such as lzf (32000), szip, nbit or scaleoffset;
string, compound, variable-length, array, reference, opaque, bitfield and
time types; shared or committed datatypes; external storage.

Writing produces what h5py's default writes: superblock v0 with the default
K (group leaf 4, group internal 16), object header v1, symbol-table groups
whose members are sorted by name (HDF5 finds a member by a binary search over
the B-tree's keys) under a B-tree as deep as the group needs, and contiguous,
unfiltered data (layout v3). A dataset's bytes go to the file when it is
created; the metadata is written on `close()`.
"""

from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np

__all__ = ["File", "Group", "Dataset"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                5: "opaque", 6: "compound", 7: "reference", 8: "enum", 9: "variable-length",
                10: "array"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _uint(buf, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos:pos + n], "little")


# ------------------------------------------------------------------ reading
class _Reader:
    """The file's bytes, its superblock's sizes and the parsers of its
    metadata structures."""

    def __init__(self, path):
        self.path = str(path)
        with open(path, "rb") as f:
            self.mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            self._superblock()
        except Exception:
            self.mm.close()
            raise
        self._headers: dict = {}
        self._groups: dict = {}

    def close(self):
        self.mm.close()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what} is not supported by the port's HDF5 reader")

    def bytes(self, addr: int, n: int) -> bytes:
        start = self.base + addr
        if addr < 0 or start + n > len(self.mm):
            raise ValueError(f"{self.path}: read of {n} bytes at {addr} past the end of the file")
        return self.mm[start:start + n]

    def _superblock(self):
        mm, at = self.mm, 0
        while at + 8 <= len(mm) and mm[at:at + 8] != _SIGNATURE:
            at = 512 if at == 0 else at * 2  # after a user block
        if at + 8 > len(mm):
            raise ValueError(f"{self.path}: not an HDF5 file (no superblock signature)")
        version = mm[at + 8]
        if version in (2, 3):
            self.fail(f"superblock v{version} (h5py's libver='latest')")
        if version not in (0, 1):
            self.fail(f"superblock v{version}")
        self.O, self.L = mm[at + 13], mm[at + 14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            self.fail(f"offsets of {self.O} bytes and lengths of {self.L}")
        self.undef = (1 << (8 * self.O)) - 1
        # addresses count from the superblock, as HDF5 reads them (it takes
        # the superblock's own address over the stored base address)
        self.base = at
        pos = at + 24 + (4 if version == 1 else 0) + 4 * self.O
        self.root = self.entry(mm[pos:pos + self.L + self.O + 24])

    def addr(self, buf, pos: int) -> int:
        return _uint(buf, pos, self.O)

    def length(self, buf, pos: int) -> int:
        return _uint(buf, pos, self.L)

    def entry(self, buf) -> int:
        """The object header address of a symbol table entry (after the
        name's heap offset, a length)."""
        return self.addr(buf, self.L)

    def header(self, addr: int) -> list:
        """The messages [(type, flags, data)] of the v1 object header at
        `addr`, its continuations followed."""
        if addr in self._headers:
            return self._headers[addr]
        head = self.bytes(addr, 16)
        if head[:4] == b"OHDR":
            self.fail("object header v2")
        if head[0] != 1:
            self.fail(f"object header v{head[0]}")
        n_msgs = struct.unpack_from("<H", head, 2)[0]
        chunks = [(addr + 16, struct.unpack_from("<I", head, 8)[0])]
        messages = []
        while chunks:
            start, size = chunks.pop(0)
            buf, pos = self.bytes(start, size), 0
            while pos + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x10:  # continuation: another chunk of messages
                    chunks.append((self.addr(data, 0), self.length(data, self.O)))
                elif mtype != 0:
                    messages.append((mtype, flags, data))
        if len(messages) > n_msgs:
            raise ValueError(f"{self.path}: object header at {addr} holds more messages than "
                             "it declares")
        self._headers[addr] = messages
        return messages

    def members(self, addr: int) -> dict:
        """name -> object header address of the group at `addr` (read once)."""
        if addr not in self._groups:
            self._groups[addr] = self._members(addr)
        return self._groups[addr]

    def _members(self, addr: int) -> dict:
        msgs = self.header(addr)
        types = {t for t, _, _ in msgs}
        if 0x11 not in types:
            if types & {0x02, 0x06}:
                self.fail("a group of link messages (new-style group, h5py's libver='latest' "
                          "or track_order)")
            self.fail("an object that is not a group")
        data = next(d for t, _, d in msgs if t == 0x11)
        btree, heap = self.addr(data, 0), self.addr(data, self.O)
        names = self._heap(heap)
        out = {}
        for snod in self._btree(btree, 0):
            head = self.bytes(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at {snod}")
            count = struct.unpack_from("<H", head, 6)[0]
            size = self.L + self.O + 24
            buf = self.bytes(snod + 8, count * size)
            for i in range(count):
                e = buf[i * size:(i + 1) * size]
                off = self.length(e, 0)
                out[names[off:names.index(b"\0", off)].decode()] = self.entry(e)
        return out

    def _heap(self, addr: int) -> bytes:
        head = self.bytes(addr, 8 + 2 * self.L + self.O)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {addr}")
        size = self.length(head, 8)
        return self.bytes(self.addr(head, 8 + 2 * self.L), size)

    def _btree(self, addr: int, node_type: int, ndims: int = 0):
        """The level-0 children of a v1 B-tree: SNOD addresses (type 0), or
        (chunk size, filter mask, offsets, address) of each chunk (type 1)."""
        key = self.L if node_type == 0 else 8 + 8 * ndims
        head = self.bytes(addr, 8 + 2 * self.O)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"{self.path}: no v1 B-tree of type {node_type} at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        buf = self.bytes(addr + 8 + 2 * self.O, used * (key + self.O) + key)
        for i in range(used):
            pos = i * (key + self.O)
            child = self.addr(buf, pos + key)
            if level > 0:
                yield from self._btree(child, node_type, ndims)
            elif node_type == 0:
                yield child
            else:
                size, mask = struct.unpack_from("<II", buf, pos)
                offsets = struct.unpack_from(f"<{ndims}Q", buf, pos + 8)
                yield size, mask, offsets, child


def _datatype(reader: _Reader, data, flags: int = 0) -> np.dtype:
    """The numpy dtype of a datatype message."""
    if flags & 0x02:
        reader.fail("a shared (committed) datatype")
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | (data[2] << 8) | (data[3] << 16)
    size = struct.unpack_from("<I", data, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            reader.fail(f"a {precision}-bit fixed-point type at bit {offset} of {size} bytes")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        offset, precision = struct.unpack_from("<HH", data, 8)
        layout = (data[12], data[13], data[15], struct.unpack_from("<I", data, 16)[0])
        if bits & 0x40 or size not in _IEEE or offset != 0 or precision != 8 * size \
                or layout != _IEEE[size] or data[14] != 0:
            reader.fail(f"a non-IEEE {precision}-bit floating-point type")
        return np.dtype(f"{order}f{size}")
    if cls == 8:
        base = _datatype(reader, data[8:])
        n = bits & 0xFFFF
        pos = 8 + (20 if base.kind == "f" else 12)
        names = []
        for _ in range(n):
            end = data.index(b"\0", pos)
            names.append(data[pos:end].decode())
            # versions 1 and 2 pad each name to a multiple of 8 bytes
            pos = end + 1 if version >= 3 else pos + -(-(end + 1 - pos) // 8) * 8
        values = np.frombuffer(data, base, count=n, offset=pos).tolist()
        if base.itemsize == 1 and base.kind == "i" and dict(zip(names, values)) == {
                "FALSE": 0, "TRUE": 1}:
            return np.dtype(bool)
        return base  # another enum: its integers, as h5py reads them
    reader.fail(f"the {_CLASS_NAMES.get(cls, f'class-{cls}')} datatype")


def _dataspace(reader: _Reader, data):
    """The shape of a dataspace message, or None for a null dataspace."""
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos, kind = 8, 1 if rank else 0
    elif version == 2:
        pos, kind = 4, data[3]
    else:
        reader.fail(f"dataspace message v{version}")
    if kind == 2:
        return None
    return tuple(reader.length(data, pos + i * reader.L) for i in range(rank))


def _fill(reader: _Reader, msgs):
    """The fill value's bytes (None: zeros) of a dataset's fill value messages."""
    for t, _, data in msgs:
        if t == 0x05:
            version = data[0]
            if version in (1, 2):
                defined = data[3]
                if version == 1 or defined:
                    size = struct.unpack_from("<I", data, 4)[0]
                    return data[8:8 + size] if size else None
                return None
            if version == 3:
                if data[1] & 0x20:
                    size = struct.unpack_from("<I", data, 2)[0]
                    return data[6:6 + size] if size else None
                return None
            reader.fail(f"fill value message v{version}")
    for t, _, data in msgs:
        if t == 0x04:
            size = struct.unpack_from("<I", data, 0)[0]
            return data[4:4 + size] if size else None
    return None


def _filters(reader: _Reader, data) -> list:
    """[(filter id, client data)] of a filter pipeline message, in the
    order they were applied on writing."""
    version, n = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos + 2)[0]
            pos += 4
        else:
            name_len = 0
            pos += 2
        n_values = struct.unpack_from("<H", data, pos + 2)[0]
        pos += 4
        name = data[pos:pos + name_len].split(b"\0")[0].decode(errors="replace")
        pos += -(-name_len // 8) * 8 if version == 1 else name_len
        values = struct.unpack_from(f"<{n_values}I", data, pos)
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (1, 2, 3):
            label = _FILTER_NAMES.get(fid, name or "unknown")
            reader.fail(f"the {label} filter ({fid})")
        out.append((fid, values))
    return out


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 checksum of `data` (16-bit big-endian words)."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n).astype(np.uint64)
    if len(data) % 2:
        words = np.append(words, np.uint64(data[-1] << 8))
    s1 = np.cumsum(words)  # exact in 64 bits for chunks under 2^32 words
    total1 = int(s1[-1]) if len(s1) else 0
    total2 = int(s1.sum()) if len(s1) else 0
    return ((total2 % 65535) << 16) | (total1 % 65535)


def _unfilter(reader: _Reader, raw: bytes, filters: list, mask: int) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, values = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            size = values[0]
            n = len(raw) // size
            body = np.frombuffer(raw, np.uint8, count=n * size).reshape(size, n).T
            raw = body.tobytes() + raw[n * size:]
        else:
            stored = struct.unpack_from("<I", raw, len(raw) - 4)[0]
            raw = raw[:-4]
            got = fletcher32(raw)
            if stored not in (got, int.from_bytes(got.to_bytes(4, "little"), "big")):
                raise ValueError(f"{reader.path}: a chunk fails its fletcher32 checksum")
    return raw


class Dataset:
    """A dataset of an open file: `shape`, `dtype`; its values by
    `np.asarray(ds)` or `ds[()]` (read when asked for)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader, self.name = reader, name
        msgs = reader.header(addr)
        by_type = {}
        for t, flags, data in msgs:
            by_type.setdefault(t, (flags, data))
        if 0x07 in by_type:
            reader.fail("external storage")
        if 0x01 not in by_type or 0x03 not in by_type or 0x08 not in by_type:
            reader.fail("an object that is neither a group nor a dataset (e.g. a committed "
                        "datatype)")
        self.shape = _dataspace(reader, by_type[0x01][1])
        self.dtype = _datatype(reader, by_type[0x03][1], by_type[0x03][0])
        self._layout = by_type[0x08][1]
        if self._layout[0] != 3:
            reader.fail(f"data layout message v{self._layout[0]}")
        if self._layout[1] not in (0, 1, 2):
            reader.fail("the virtual data layout" if self._layout[1] == 3
                        else f"data layout class {self._layout[1]}")
        self._filters = _filters(reader, by_type[0x0B][1]) if 0x0B in by_type else []
        self._fill = _fill(reader, msgs)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape or (), dtype=np.int64))

    def _empty(self, shape):
        # the file's element type; h5py's bool is stored as int8
        store = np.dtype(np.int8) if self.dtype == bool else self.dtype
        if self._fill is None:
            return np.zeros(shape, self.dtype)
        fill = np.frombuffer(self._fill[:store.itemsize], store)[0]
        return np.full(shape, fill, store).astype(self.dtype)

    def _read(self) -> np.ndarray:
        r, lay = self._reader, self._layout
        if self.shape is None:  # a null dataspace holds no value
            return np.zeros((0,), self.dtype)
        store = np.dtype(np.int8) if self.dtype == bool else self.dtype
        n = self.size
        if lay[1] == 0:  # compact: the bytes are in the message
            size = struct.unpack_from("<H", lay, 2)[0]
            out = np.frombuffer(lay, store, count=n, offset=4) if size else np.zeros(0, store)
            return out.reshape(self.shape).astype(self.dtype)
        if lay[1] == 1:
            addr = r.addr(lay, 2)
            if addr == r.undef or n == 0:
                return self._empty(self.shape)
            raw = r.bytes(addr, n * store.itemsize)
            return np.frombuffer(raw, store).reshape(self.shape).astype(self.dtype)
        ndims = lay[2]
        btree = r.addr(lay, 3)
        chunk = struct.unpack_from(f"<{ndims}I", lay, 3 + r.O)[:-1]
        out = self._empty(self.shape)
        if btree == r.undef or n == 0:
            return out
        for size, mask, offsets, addr in r._btree(btree, 1, ndims):
            raw = _unfilter(r, r.bytes(addr, size), self._filters, mask)
            block = np.frombuffer(raw, store, count=int(np.prod(chunk))).reshape(chunk)
            start = offsets[:-1]
            dst = tuple(slice(s, min(s + c, d)) for s, c, d in zip(start, chunk, self.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src].astype(self.dtype)
        return out

    def __array__(self, dtype=None, copy=None):
        out = self._read()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        return self._read()[key]

    def __repr__(self):
        return f'<HDF5 dataset "{self.name}": shape {self.shape}, type "{self.dtype.str}">'


class Group:
    """A group of an open file: `g[path]`, `keys()`, `in`, `len()`."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader, self._addr, self.name = reader, addr, name

    def _links(self) -> dict:
        return self._reader.members(self._addr)

    def _child(self, name: str):
        addr = self._links()[name]
        path = f"{self.name.rstrip('/')}/{name}"
        # a symbol table (or the link messages that `members` refuses by name)
        if any(t in (0x02, 0x06, 0x11) for t, _, _ in self._reader.header(addr)):
            return Group(self._reader, addr, path)
        return Dataset(self._reader, addr, path)

    def __getitem__(self, path: str):
        path = str(path)
        node = self._root() if path.startswith("/") else self
        for part in (p for p in path.split("/") if p and p != "."):
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name} is a dataset")
            if part not in node._links():
                raise KeyError(f"{path!r}: no {part!r} in {node.name}")
            node = node._child(part)
        return node

    def _root(self):
        return Group(self._reader, self._reader.root, "/")

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> list:
        return list(self._links())

    def __len__(self):
        return len(self._links())

    def __repr__(self):
        return f'<HDF5 group "{self.name}" ({len(self)} members)>'


# ------------------------------------------------------------------ writing
_O = _L = 8  # offsets and lengths of the files written here
_UNDEF = b"\xff" * 8
_LEAF_K, _NODE_K = 4, 16  # h5py's default group leaf and internal K
_ENTRY = 40  # a symbol table entry at 8-byte offsets
_SUPERBLOCK = 96


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype == bool:  # h5py's bool: an enum over int8, FALSE = 0, TRUE = 1
        base = _datatype_message(np.dtype(np.int8))
        names = _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
        return struct.pack("<BHBI", 0x18, 2, 0, 1) + base + names + b"\x00\x01"
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                             np.little_endian is False) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<BHBIHH", 0x10, bits, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _IEEE:
        exp_loc, exp_size, mant_size, bias = _IEEE[size]
        bits = order | 0x20 | ((8 * size - 1) << 8)  # implied MSB normalisation, sign bit
        return struct.pack("<BHBIHHBBBBI", 0x11, bits & 0xFFFF, bits >> 16, size, 0, 8 * size,
                           exp_loc, exp_size, 0, mant_size, bias)
    raise ValueError(f"the port's HDF5 writer does not write {dtype} data (bool, integers "
                     "and IEEE floats of 1 to 8 bytes)")


def _dataspace_message(shape: tuple) -> bytes:
    dims = b"".join(struct.pack("<Q", d) for d in shape)
    return struct.pack("<BBBx4x", 1, len(shape), 1 if shape else 0) + dims + (dims if shape
                                                                               else b"")


class _WGroup:
    def __init__(self):
        self.members: dict = {}


class _WDataset:
    def __init__(self, shape, dtype, addr, nbytes):
        self.shape, self.dtype, self.addr, self.nbytes = shape, dtype, addr, nbytes


class _WriterGroup:
    """A group of a file open for writing."""

    def __init__(self, file: "File", node: _WGroup, name: str):
        self._file, self._node, self.name = file, node, name

    def _walk(self, path: str):
        """(the parent group of `path`, made as needed; its last name)."""
        node, parts = self._node, [p for p in str(path).split("/") if p]
        if str(path).startswith("/"):
            node = self._file._tree
        if not parts:
            raise ValueError("an empty name")
        for part in parts[:-1]:
            child = node.members.get(part)
            if child is None:
                child = node.members[part] = _WGroup()
            if not isinstance(child, _WGroup):
                raise KeyError(f"{path!r}: {part!r} is not a group")
            node = child
        return node, parts[-1]

    def create_group(self, name: str) -> "_WriterGroup":
        parent, last = self._walk(name)
        if last in parent.members:
            raise ValueError(f"{name!r} exists")
        parent.members[last] = _WGroup()
        return _WriterGroup(self._file, parent.members[last], f"{self.name.rstrip('/')}/{name}")

    def create_dataset(self, name: str, data=None):
        if data is None:
            raise ValueError("create_dataset needs `data`")
        arr = np.asarray(data)
        _datatype_message(arr.dtype)  # refuse what cannot be written before any byte
        parent, last = self._walk(name)
        if last in parent.members:
            raise ValueError(f"{name!r} exists")
        store = arr.astype(np.int8) if arr.dtype == bool else arr
        parent.members[last] = self._file._append(store, arr.dtype)

    def __setitem__(self, name, data):
        self.create_dataset(name, data=data)


class File:
    """`File(path, "r")` reads, `File(path, "w")` writes (truncating); a
    context manager either way."""

    def __init__(self, path, mode: str = "r"):
        self.filename = str(path)
        self.mode = mode
        if mode == "r":
            self._reader = _Reader(path)
            self._group = Group(self._reader, self._reader.root, "/")
        elif mode == "w":
            self._f = open(path, "wb")
            self._f.write(b"\0" * _SUPERBLOCK)
            self._tree = _WGroup()
            self._group = _WriterGroup(self, self._tree, "/")
        else:
            raise ValueError(f"mode {mode!r}: the port's HDF5 files open as 'r' or 'w'")
        self._open = True

    # the root group's interface
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._group, name)

    def __getitem__(self, path):
        return self._group[path]

    def __setitem__(self, name, data):
        self._group[name] = data

    def __contains__(self, path) -> bool:
        return path in self._group

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # a file being written is finished when dropped, as h5py's is; one
        # being read stays open while its groups and datasets are referenced
        if getattr(self, "mode", None) == "w":
            try:
                self.close()
            except Exception:
                pass

    def close(self):
        if not getattr(self, "_open", False):
            return
        self._open = False
        if self.mode == "r":
            self._reader.close()
            return
        try:
            root = self._write_group(self._tree)
            eof = self._f.seek(0, 2)
            self._f.seek(0)
            self._f.write(self._superblock(eof, root))
        finally:
            self._f.close()

    # ---- writing
    def _tell(self) -> int:
        return self._f.seek(0, 2)

    def _put(self, data: bytes) -> int:
        addr = self._tell()
        pad = -addr % 8
        if pad:
            self._f.write(b"\0" * pad)
            addr += pad
        self._f.write(data)
        return addr

    def _append(self, arr: np.ndarray, dtype) -> _WDataset:
        nbytes = arr.nbytes
        addr = self._put(arr.tobytes()) if nbytes else None
        return _WDataset(arr.shape, np.dtype(dtype), addr, nbytes)

    def _write_dataset(self, ds: _WDataset) -> int:
        messages = [
            _message(0x01, _dataspace_message(ds.shape)),
            _message(0x03, _datatype_message(ds.dtype), flags=1),  # constant
            # fill value v2: allocation late, written if set, the library's default
            _message(0x05, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),
            _message(0x08, struct.pack("<BB", 3, 1)
                     + (struct.pack("<Q", ds.addr) if ds.addr is not None else _UNDEF)
                     + struct.pack("<Q", ds.nbytes)),
        ]
        return self._put(_object_header(messages))

    def _write_group(self, group: _WGroup) -> tuple:
        """Write a group's members, heap, nodes and header; returns (object
        header address, B-tree address, heap address)."""
        names = sorted(group.members, key=lambda s: s.encode())
        entries = []
        for name in names:
            node = group.members[name]
            if isinstance(node, _WGroup):
                entries.append((name, *self._write_group(node)))
            else:
                entries.append((name, self._write_dataset(node), None, None))
        # the local heap: "" at offset 0, then each name, 8-byte aligned
        heap, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap)
            heap += _pad8(name.encode() + b"\0")
        data_addr = self._put(bytes(heap))
        # free list offset 1: no free block (HDF5's H5HL_FREE_NULL)
        heap_addr = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, data_addr))
        # symbol table nodes of at most 2 K entries, then the B-tree over them
        snods, keys = [], []
        for i in range(0, len(entries), 2 * _LEAF_K) or [0]:
            chunk = entries[i:i + 2 * _LEAF_K]
            body = b"".join(self._entry(offsets[n], oh, bt, hp) for n, oh, bt, hp in chunk)
            body += b"\0" * (2 * _LEAF_K * _ENTRY - len(body))
            snods.append(self._put(b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body))
            keys.append(offsets[chunk[-1][0]] if chunk else 0)
        btree = self._write_btree(snods, keys)
        stab = struct.pack("<QQ", btree, heap_addr)
        return self._put(_object_header([_message(0x11, stab)])), btree, heap_addr

    def _write_btree(self, children: list, keys: list) -> int:
        """A v1 group B-tree over `children` (key i + 1 the heap offset of
        the last name under child i), as many levels as 2 K children a node
        need; returns the root's address."""
        level = 0
        while True:
            nodes, node_keys = [], []
            for i in range(0, len(children), 2 * _NODE_K):
                nodes.append((children[i:i + 2 * _NODE_K], keys[i:i + 2 * _NODE_K]))
            size = 8 + 2 * _O + (2 * _NODE_K + 1) * _L + 2 * _NODE_K * _O
            first = self._tell() + (-self._tell() % 8)
            addrs = [first + j * size for j in range(len(nodes))]
            for j, (kids, ks) in enumerate(nodes):
                left = struct.pack("<Q", addrs[j - 1]) if j else _UNDEF
                right = struct.pack("<Q", addrs[j + 1]) if j + 1 < len(nodes) else _UNDEF
                body = struct.pack("<Q", 0)  # key 0: the empty name
                for kid, key in zip(kids, ks):
                    body += struct.pack("<QQ", kid, key)
                node = b"TREE" + struct.pack("<BBH", 0, level, len(kids)) + left + right + body
                node += b"\0" * (size - len(node))
                if self._put(node) != addrs[j]:
                    raise AssertionError("B-tree nodes are not contiguous")
                node_keys.append(ks[-1])
            if len(nodes) == 1:
                return addrs[0]
            children, keys, level = addrs, node_keys, level + 1

    @staticmethod
    def _entry(name_offset, header, btree, heap) -> bytes:
        if btree is None:  # a dataset: nothing cached
            return struct.pack("<QQII16x", name_offset, header, 0, 0)
        return struct.pack("<QQIIQQ", name_offset, header, 1, 0, btree, heap)

    def _superblock(self, eof: int, root: tuple) -> bytes:
        header, btree, heap = root
        return (_SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, _O, _L, 0)
                + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
                + struct.pack("<QQIIQQ", 0, header, 1, 0, btree, heap))
