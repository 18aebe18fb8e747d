"""The port's own HDF5 reader and writer, pure Python and numpy: the subset
of the format that h5py writes by default, which is what a Keras ``.h5``
file holds. It needs neither h5py nor the HDF5 library.

The subset:

- superblock version 0 or 1, 8-byte offsets and lengths;
- version-1 object headers, with continuation messages;
- old-style groups: a symbol-table message, a version-1 B-tree of type 0
  (leaf and internal nodes) over symbol-table nodes (SNOD), names in a
  local heap;
- messages: NIL, dataspace (versions 1 and 2), datatype, fill value,
  layout (version 3, contiguous and compact), attribute (versions 1-3),
  symbol table, continuation and modification time;
- datatypes: little-endian fixed-point and IEEE float, fixed-length
  strings, variable-length strings (their bytes in global-heap
  collections).

Anything else raises ``ValueError`` naming the feature: a chunked or
filtered dataset, dense attribute storage, a new-style group (link
messages), superblock versions 2 and 3, version-2 object headers, a
big-endian or an unknown datatype, a shared message.

Reading: ``File(path)`` gives the root ``Group``; a group maps member
names (or ``a/b/c`` paths) to groups and ``Dataset``s, and both have
``attrs``, a dict read from the object header. A dataset's ``read()``
(or ``np.asarray(ds)``) reads its bytes in one call at their file offset. Attribute values come back as h5py gives them: a
variable-length string as ``str``, an array of them as an object array of
``str``, a fixed-length string as ``numpy.bytes_``, a scalar number as a
numpy scalar.

Writing: ``write(path, root)`` with ``root`` a ``WGroup`` whose members
are ``WGroup``s and numpy arrays (datasets, written contiguous and
uncompressed). Attribute values: ``str`` is a variable-length UTF-8
string, ``bytes`` a variable-length ASCII one, a list or tuple of either
a 1-D array of them, an empty list an empty float64 array (h5py's reading
of ``[]``), a numpy array or scalar a number array (``S`` arrays are
fixed-length strings). Large arrays go to the file straight from their
buffers.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_FREE_NULL = 1  # the end of a local heap's free list on disk

# Object header message types (the others the reader meets, fill value and
# modification time among them, it skips).
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x0, 0x1, 0x2, 0x3, 0x5
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS = 0x6, 0x7, 0x8, 0xA, 0xB
_ATTRIBUTE, _SHARED_TABLE, _CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0xC, 0xF, 0x10, 0x11, 0x15
_REFUSED_MESSAGES = {
    _LINK_INFO: "new-style group (link info message)",
    _LINK: "new-style group (link messages)",
    _GROUP_INFO: "new-style group (group info message)",
    _EXTERNAL: "external data files",
    _FILTERS: "filtered dataset (filter pipeline)",
    _SHARED_TABLE: "shared object header messages",
}
_CLASS_NAMES = {
    0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
    5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
    9: "variable-length", 10: "array",
}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------
# Datatypes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Type:
    """A decoded datatype: ``kind`` is "num" (``dtype`` a little-endian
    numpy dtype), "fstr" (fixed-length, ``size`` bytes) or "vstr"
    (variable-length string). ``size`` is the element's size in the file."""

    kind: str
    size: int
    dtype: np.dtype | None = None


def _parse_datatype(buf: bytes, p: int = 0) -> tuple[_Type, int]:
    """The datatype message at ``buf[p:]`` -> (type, its length)."""
    head = buf[p]
    cls, bits = head & 0x0F, buf[p + 1] | (buf[p + 2] << 8) | (buf[p + 3] << 16)
    (size,) = struct.unpack_from("<I", buf, p + 4)
    if cls == 0:
        if bits & 1:
            raise ValueError("HDF5: big-endian datatype is not supported")
        if size not in (1, 2, 4, 8):
            raise ValueError(f"HDF5: {size}-byte fixed-point datatype is not supported")
        dt = np.dtype(("<i" if bits & 0x8 else "<u") + str(size))
        return _Type("num", size, dt), 12
    if cls == 1:
        if bits & 1 or bits & 0x40:
            raise ValueError("HDF5: big-endian datatype is not supported")
        if size not in (2, 4, 8):
            raise ValueError(f"HDF5: {size}-byte floating-point datatype is not supported")
        return _Type("num", size, np.dtype("<f" + str(size))), 20
    if cls == 3:
        return _Type("fstr", size), 8
    if cls == 9:
        if bits & 0xF != 1:
            raise ValueError("HDF5: variable-length sequence datatype is not supported")
        _, base_len = _parse_datatype(buf, p + 8)
        return _Type("vstr", size), 8 + base_len
    raise ValueError(
        f"HDF5: datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')}) is not supported"
    )


def _parse_dataspace(buf: bytes, p: int = 0) -> tuple[int, ...] | None:
    """-> the shape, () for a scalar, None for a null dataspace."""
    version, ndim, flags = buf[p], buf[p + 1], buf[p + 2]
    if version == 1:
        q = p + 8
    elif version == 2:
        if buf[p + 3] == 2:
            return None
        q = p + 4
    else:
        raise ValueError(f"HDF5: dataspace message version {version} is not supported")
    return struct.unpack_from(f"<{ndim}Q", buf, q) if ndim else ()


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------


class File:
    """An HDF5 file opened for reading (a context manager). ``attrs``,
    ``keys()``, ``[path]`` and ``in`` act on the root group."""

    def __init__(self, path):
        self.path = path
        self._base = 0
        self._f = open(path, "rb")
        try:
            self._read_superblock()
        except Exception:
            self._f.close()
            raise
        self._collections: dict[int, bytes] = {}
        self.root = Group(self, "/", self._root_addr)

    def _read_superblock(self) -> None:
        if self._f.read(8) != _SIGNATURE:
            raise ValueError(f"HDF5: {self.path} is not an HDF5 file (no signature at 0)")
        head = self._read(0, 24)
        version = head[8]
        if version not in (0, 1):
            raise ValueError(f"HDF5: superblock version {version} is not supported")
        if head[13] != 8 or head[14] != 8:
            raise ValueError(
                f"HDF5: {head[13]}-byte offsets / {head[14]}-byte lengths are not supported"
            )
        p = 24 + (4 if version == 1 else 0)
        base = struct.unpack("<Q", self._read(p, 8))[0]
        entry = self._read(p + 32, 40)
        (self._root_addr,) = struct.unpack_from("<Q", entry, 8)
        self._base = base

    def _read(self, addr: int, n: int) -> bytes:
        self._f.seek(self._base + addr)
        out = self._f.read(n)
        if len(out) != n:
            raise ValueError(f"HDF5: {self.path} ends before byte {addr + n}")
        return out

    def _fromfile(self, addr: int, dtype, count: int) -> np.ndarray:
        self._f.seek(self._base + addr)
        out = np.fromfile(self._f, dtype=dtype, count=count)
        if out.size != count:
            raise ValueError(f"HDF5: {self.path} ends inside a dataset at byte {addr}")
        return out

    def _heap_object(self, addr: int, index: int) -> bytes:
        coll = self._collections.get(addr)
        if coll is None:
            head = self._read(addr, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"HDF5: no global heap collection at {addr}")
            (size,) = struct.unpack_from("<Q", head, 8)
            coll = self._collections[addr] = self._read(addr, size)
        p = 16
        while p + 16 <= len(coll):
            idx, _, size = struct.unpack_from("<HH4xQ", coll, p)
            if idx == 0:
                break
            if idx == index:
                return coll[p + 16 : p + 16 + size]
            p += 16 + _pad8(size)
        raise ValueError(f"HDF5: global heap object {index} missing in collection {addr}")

    def _decode(self, raw: bytes, typ: _Type, shape) -> object:
        """Raw element bytes -> an h5py-like value."""
        n = int(np.prod(shape)) if shape else 1
        if typ.kind == "num":
            arr = np.frombuffer(raw, typ.dtype, n).reshape(shape)
        elif typ.kind == "fstr":
            arr = np.frombuffer(raw, f"S{typ.size}", n).reshape(shape)
        else:
            vals = []
            for i in range(n):
                length, addr, idx = struct.unpack_from("<IQI", raw, 16 * i)
                data = self._heap_object(addr, idx)[:length] if length else b""
                vals.append(data.decode("utf-8"))  # UTF-8 reads ASCII too
            if not shape:
                return vals[0]
            arr = np.empty(n, dtype=object)
            arr[:] = vals
            arr = arr.reshape(shape)
        return arr[()] if not shape else arr

    def _object(self, addr: int, name: str):
        msgs = _read_header(self, addr)
        if _SYMBOL_TABLE in msgs:
            return Group(self, name, addr, msgs)
        if _LAYOUT in msgs:
            return Dataset(self, name, addr, msgs)
        raise ValueError(f"HDF5: object {name} is neither an old-style group nor a dataset")

    # Root-group conveniences.
    @property
    def attrs(self) -> dict:
        return self.root.attrs

    def keys(self):
        return self.root.keys()

    def __getitem__(self, path):
        return self.root[path]

    def __contains__(self, path) -> bool:
        return path in self.root

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_header(file: File, addr: int) -> dict[int, list[bytes]]:
    """A version-1 object header's messages, continuation blocks followed:
    {message type: [message bytes, ...]} in file order."""
    head = file._read(addr, 16)
    if head[:4] == b"OHDR":
        raise ValueError(f"HDF5: {_v2_header_feature(file, addr)} is not supported")
    version, nmsgs, size = head[0], *struct.unpack_from("<H4xI", head, 2)
    if version != 1:
        raise ValueError(f"HDF5: object header version {version} is not supported")
    blocks = [(addr + 16, size)]
    msgs: dict[int, list[bytes]] = {}
    seen = 0
    while blocks:
        start, length = blocks.pop(0)
        buf = file._read(start, length)
        p = 0
        while p + 8 <= length:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
            body = buf[p + 8 : p + 8 + msize]
            p += 8 + msize
            seen += 1
            if flags & 0x2:
                raise ValueError("HDF5: shared object header message is not supported")
            if mtype in _REFUSED_MESSAGES:
                raise ValueError(f"HDF5: {_REFUSED_MESSAGES[mtype]} is not supported")
            if mtype == _CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", body))
            elif mtype == _ATTR_INFO:
                _check_attr_info(body)
            elif mtype != _NIL:
                msgs.setdefault(mtype, []).append(body)
    if seen != nmsgs:
        raise ValueError(f"HDF5: object header at {addr} holds {seen} messages, says {nmsgs}")
    return msgs


def _v2_header_feature(file: File, addr: int) -> str:
    """The feature a version-2 object header stands for: a new-style group
    or dense attributes when its first chunk says so."""
    head = file._read(addr, 6)
    flags = head[5]
    p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size = int.from_bytes(file._read(p, width), "little")
    buf = file._read(p + width, size)
    q, step = 0, 6 if flags & 0x04 else 4
    while q + step <= len(buf):
        mtype, msize = buf[q], int.from_bytes(buf[q + 1 : q + 3], "little")
        if mtype in (_LINK_INFO, _LINK, _GROUP_INFO):
            return "new-style group (link messages, version-2 object header)"
        if mtype == _ATTR_INFO:
            try:
                _check_attr_info(buf[q + step : q + step + msize])
            except ValueError as e:
                return str(e).removeprefix("HDF5: ").removesuffix(" is not supported")
        q += step + msize
    return "version-2 object header"


def _check_attr_info(body: bytes) -> None:
    flags = body[1]
    p = 2 + (2 if flags & 1 else 0)
    (heap,) = struct.unpack_from("<Q", body, p)
    if heap != _UNDEF:
        raise ValueError("HDF5: dense attribute storage is not supported")


def _parse_attribute(file: File, body: bytes) -> tuple[str, object]:
    version = body[0]
    if version not in (1, 2, 3):
        raise ValueError(f"HDF5: attribute message version {version} is not supported")
    if version > 1 and body[1] & 0x3:
        raise ValueError("HDF5: shared attribute datatype or dataspace is not supported")
    name_len, dt_len, ds_len = struct.unpack_from("<HHH", body, 2)
    p = 8 if version < 3 else 9
    step = _pad8 if version == 1 else (lambda n: n)
    name = body[p : p + name_len].rstrip(b"\0").decode("utf-8")
    p += step(name_len)
    typ, _ = _parse_datatype(body, p)
    p += step(dt_len)
    shape = _parse_dataspace(body, p)
    p += step(ds_len)
    if shape is None:
        return name, None
    n = int(np.prod(shape)) if shape else 1
    return name, file._decode(body[p : p + n * typ.size], typ, shape)


class _Object:
    def __init__(self, file: File, name: str, addr: int, msgs=None):
        self.file = file
        self.name = name
        self.addr = addr
        self._msgs = msgs
        self._attrs = None

    def _messages(self) -> dict[int, list[bytes]]:
        if self._msgs is None:
            self._msgs = _read_header(self.file, self.addr)
        return self._msgs

    @property
    def attrs(self) -> dict:
        if self._attrs is None:
            self._attrs = dict(
                _parse_attribute(self.file, body)
                for body in self._messages().get(_ATTRIBUTE, [])
            )
        return self._attrs


class Group(_Object):
    """An old-style group: its members, sorted by name as HDF5 keeps them."""

    def __init__(self, file, name, addr, msgs=None):
        super().__init__(file, name, addr, msgs)
        self._members = None

    @property
    def members(self) -> dict[str, int]:
        """name -> object header address."""
        if self._members is None:
            msgs = self._messages()
            if _SYMBOL_TABLE not in msgs:
                raise ValueError(f"HDF5: {self.name} is not an old-style group")
            btree, heap = struct.unpack_from("<QQ", msgs[_SYMBOL_TABLE][0])
            names = _local_heap(self.file, heap)
            out: dict[str, int] = {}
            _walk_btree(self.file, btree, names, out)
            self._members = out
        return self._members

    def keys(self):
        return list(self.members)

    def __iter__(self):
        return iter(self.members)

    def __len__(self) -> int:
        return len(self.members)

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in (s for s in path.split("/") if s):
            if not isinstance(node, Group) or part not in node.members:
                raise KeyError(f"{path!r} not in {self.name}")
            child = f"{node.name.rstrip('/')}/{part}"
            node = self.file._object(node.members[part], child)
        return node


def _local_heap(file: File, addr: int) -> bytes:
    head = file._read(addr, 32)
    if head[:4] != b"HEAP":
        raise ValueError(f"HDF5: no local heap at {addr}")
    size, _, data = struct.unpack_from("<QQQ", head, 8)
    return file._read(data, size)


def _heap_name(names: bytes, offset: int) -> str:
    return names[offset : names.index(b"\0", offset)].decode("utf-8")


def _walk_btree(file: File, addr: int, names: bytes, out: dict) -> None:
    head = file._read(addr, 24)
    if head[:4] != b"TREE":
        raise ValueError(f"HDF5: no B-tree node at {addr}")
    node_type, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
    if node_type != 0:
        raise ValueError(f"HDF5: B-tree node type {node_type} where a group's was expected")
    body = file._read(addr + 24, 8 + used * 16)
    children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
    for child in children:
        if level > 0:
            _walk_btree(file, child, names, out)
            continue
        snod = file._read(child, 8)
        if snod[:4] != b"SNOD":
            raise ValueError(f"HDF5: no symbol table node at {child}")
        (count,) = struct.unpack_from("<H", snod, 6)
        entries = file._read(child + 8, 40 * count)
        for i in range(count):
            off, obj = struct.unpack_from("<QQ", entries, 40 * i)
            out[_heap_name(names, off)] = obj


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype`` and ``read()``."""

    def __init__(self, file, name, addr, msgs=None):
        super().__init__(file, name, addr, msgs)
        msgs = self._messages()
        if _DATATYPE not in msgs or _DATASPACE not in msgs:
            raise ValueError(f"HDF5: dataset {name} lacks a datatype or a dataspace")
        self._type, _ = _parse_datatype(msgs[_DATATYPE][0])
        shape = _parse_dataspace(msgs[_DATASPACE][0])
        self.shape = () if shape is None else tuple(int(d) for d in shape)
        layout = msgs[_LAYOUT][0]
        if layout[0] != 3:
            raise ValueError(f"HDF5: data layout message version {layout[0]} is not supported")
        self._layout = layout
        if layout[1] == 2:
            raise ValueError(f"HDF5: chunked dataset {name} is not supported")
        if layout[1] not in (0, 1):
            raise ValueError(f"HDF5: layout class {layout[1]} of {name} is not supported")

    @property
    def dtype(self) -> np.dtype:
        t = self._type
        return t.dtype if t.kind == "num" else np.dtype(f"S{t.size}" if t.kind == "fstr" else "O")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def read(self) -> np.ndarray:
        t, n, layout = self._type, self.size, self._layout
        nbytes = n * t.size
        if layout[1] == 0:
            (csize,) = struct.unpack_from("<H", layout, 2)
            raw = layout[4 : 4 + csize]
        else:
            addr, size = struct.unpack_from("<QQ", layout, 2)
            if addr == _UNDEF or n == 0:
                return np.zeros(self.shape, self.dtype)
            if size < nbytes:
                raise ValueError(f"HDF5: dataset {self.name} holds {size} of {nbytes} bytes")
            if t.kind != "vstr":
                dt = t.dtype if t.kind == "num" else np.dtype(f"S{t.size}")
                return self.file._fromfile(addr, dt, n).reshape(self.shape)
            raw = self.file._read(addr, nbytes)
        out = self.file._decode(raw, t, self.shape)
        return np.asarray(out) if not self.shape else out

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WGroup:
    """A group to write: ``members`` maps names to ``WGroup``s and numpy
    arrays, ``attrs`` names to attribute values (see the module's doc)."""

    members: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)


_LEAF_K, _INTERNAL_K = 4, 16  # h5py's defaults: 8 entries an SNOD, 32 children a node
_MIN_COLLECTION = 4096


def _dtype_message(dt: np.dtype, vlen_cset: int | None = None) -> bytes:
    if vlen_cset is not None:
        base = struct.pack("<B3xIHH", 0x10, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, vlen_cset, 0, 16) + base
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x8 if dt.kind == "i" else 0, 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f":
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        bits = 8 * dt.itemsize
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, bits - 1, 0, dt.itemsize,
                           0, bits, mant, exp, 0, mant, bias)
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)  # null-padded ASCII
    raise ValueError(f"HDF5 writer: dtype {dt} is not supported")


def _dataspace_message(shape: tuple[int, ...], maxdims: bool = False) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), 1 if maxdims else 0, 0) + dims + (
        dims if maxdims else b""
    )


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    if len(body) > 0xFFFF:
        raise ValueError(
            f"HDF5 writer: a {len(body)}-byte object header message exceeds 64 KiB "
            "(dense attribute storage is not supported)"
        )
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _le(arr: np.ndarray) -> np.ndarray:
    dt = arr.dtype
    if dt.kind not in "iufS" or (dt.kind in "iuf" and dt.itemsize not in (1, 2, 4, 8)):
        raise ValueError(f"HDF5 writer: dtype {dt} is not supported")
    if dt.byteorder == ">":
        arr = arr.astype(dt.newbyteorder("<"))
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


class _Writer:
    def __init__(self):
        self.pos = 96  # the superblock
        self.blocks: list[tuple[int, object]] = []
        self.collections: list[list] = []  # [address, capacity, [payloads]]

    def alloc(self, n: int) -> int:
        addr = self.pos
        self.pos += _pad8(n)
        return addr

    def put(self, data) -> int:
        addr = self.alloc(data.nbytes if isinstance(data, np.ndarray) else len(data))
        self.blocks.append((addr, data))
        return addr

    def heap_id(self, data: bytes) -> bytes:
        """A global-heap object holding ``data`` -> the 16 bytes of a
        variable-length string element that point at it."""
        if not data:
            return struct.pack("<IQI", 0, 0, 0)
        need = 16 + _pad8(len(data))
        coll = self.collections[-1] if self.collections else None
        if coll is None or coll[1] - coll[2] < need + 16 or len(coll[3]) == 0xFFFE:
            cap = max(_MIN_COLLECTION, _pad8(16 + need + 16))
            coll = [self.alloc(cap), cap, 16, []]
            self.collections.append(coll)
        coll[3].append(data)
        coll[2] += need
        return struct.pack("<IQI", len(data), coll[0], len(coll[3]))

    def attribute(self, name: str, value) -> bytes:
        dtype_msg, shape, raw = self._attr_value(value)
        name_b = name.encode("utf-8") + b"\0"
        space = _dataspace_message(shape)
        body = struct.pack("<BxHHH", 1, len(name_b), len(dtype_msg), len(space))
        for part in (name_b, dtype_msg, space):
            body += part + b"\0" * (_pad8(len(part)) - len(part))
        return _message(_ATTRIBUTE, body + raw)

    def _attr_value(self, value):
        if isinstance(value, (str, bytes)) and not isinstance(value, np.generic):
            return self._vlen([value], ())
        if isinstance(value, (list, tuple)):
            if not value:
                return _dtype_message(np.dtype("<f8")), (0,), b""
            if all(isinstance(v, (str, bytes)) for v in value):
                return self._vlen(list(value), (len(value),))
            value = np.asarray(value)
        arr = _le(np.asarray(value))
        return _dtype_message(arr.dtype), arr.shape, arr.tobytes()

    def _vlen(self, values, shape):
        cset = 0 if all(isinstance(v, bytes) for v in values) else 1
        raw = b"".join(
            self.heap_id(v if isinstance(v, bytes) else v.encode("utf-8")) for v in values
        )
        return _dtype_message(None, vlen_cset=cset), shape, raw

    def header(self, messages: list[bytes]) -> int:
        body = b"".join(messages)
        return self.put(struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body)

    def dataset(self, arr: np.ndarray, attrs: dict) -> int:
        arr = _le(arr)
        data_addr = self.put(arr) if arr.nbytes else _UNDEF
        msgs = [
            _message(_DATASPACE, _dataspace_message(arr.shape, maxdims=True)),
            _message(_DATATYPE, _dtype_message(arr.dtype), flags=1),
            _message(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)),
        ]
        msgs += [self.attribute(k, v) for k, v in attrs.items()]
        return self.header(msgs)

    def group(self, g: WGroup) -> tuple[int, int, int]:
        """-> (object header, B-tree, local heap) addresses."""
        entries = []
        for name in sorted(g.members, key=lambda s: s.encode("utf-8")):
            child = g.members[name]
            if isinstance(child, WGroup):
                hdr, btree, heap = self.group(child)
                entries.append((name, hdr, struct.pack("<IIQQ", 1, 0, btree, heap)))
            else:
                entries.append((name, self.dataset(np.asarray(child), {}), bytes(24)))
        heap_addr, offsets = self.local_heap([e[0] for e in entries])
        btree = self.btree(entries, offsets)
        msgs = [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]
        msgs += [self.attribute(k, v) for k, v in g.attrs.items()]
        return self.header(msgs), btree, heap_addr

    def local_heap(self, names: list[str]) -> tuple[int, list[int]]:
        data = bytearray(8)  # offset 0: the empty name
        offsets = []
        for name in names:
            offsets.append(len(data))
            b = name.encode("utf-8") + b"\0"
            data += b + b"\0" * (_pad8(len(b)) - len(b))
        free = len(data)
        data += struct.pack("<QQ", _FREE_NULL, 16)  # one free block
        data_addr = self.put(bytes(data))
        head = b"HEAP" + struct.pack("<B3xQQQ", 0, len(data), free, data_addr)
        return self.put(head), offsets

    def btree(self, entries, offsets) -> int:
        """Version-1 group B-tree over full SNODs; internal levels as needed."""
        per_snod = 2 * _LEAF_K
        snods = []  # (address, heap offset of its last name)
        for s in range(0, len(entries), per_snod):
            chunk = entries[s : s + per_snod]
            body = b"SNOD" + struct.pack("<BxH", 1, len(chunk))
            for (name, hdr, scratch), off in zip(chunk, offsets[s : s + per_snod]):
                body += struct.pack("<QQ", off, hdr) + scratch
            body += bytes(40 * (per_snod - len(chunk)))
            snods.append((self.put(body), offsets[s + len(chunk) - 1]))
        level, children = 0, snods
        fanout = 2 * _INTERNAL_K
        # A node: its header, then keys and children interleaved, room for
        # fanout children and fanout + 1 keys (the size the library reads).
        node_size = 24 + (2 * fanout + 1) * 8
        while True:
            groups = [children[i : i + fanout] for i in range(0, len(children), fanout)] or [[]]
            addrs = [self.alloc(node_size) for _ in groups]
            nodes = []
            left_key = 0
            for i, (grp, addr) in enumerate(zip(groups, addrs)):
                left = addrs[i - 1] if i else _UNDEF
                right = addrs[i + 1] if i + 1 < len(addrs) else _UNDEF
                body = b"TREE" + struct.pack("<BBHQQ", 0, level, len(grp), left, right)
                body += struct.pack("<Q", left_key)
                for child, key in grp:
                    body += struct.pack("<QQ", child, key)
                body += bytes(node_size - len(body))
                nodes.append((addr, body, grp[-1][1] if grp else 0))
                if grp:
                    left_key = grp[-1][1]
            self.blocks += [(addr, body) for addr, body, _ in nodes]
            if len(nodes) == 1:
                return nodes[0][0]
            children = [(addr, key) for addr, _, key in nodes]
            level += 1

    def finish(self, path, root_entry: tuple[int, int, int]) -> None:
        for addr, cap, _, payloads in self.collections:
            body = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, cap))
            for i, data in enumerate(payloads, 1):
                body += struct.pack("<HH4xQ", i, 0, len(data)) + data
                body += b"\0" * (_pad8(len(data)) - len(data))
            rest = cap - len(body)
            if rest >= 16:
                body += struct.pack("<HH4xQ", 0, 0, rest) + bytes(rest - 16)
            else:
                body += bytes(rest)
            self.blocks.append((addr, bytes(body)))
        hdr, btree, heap = root_entry
        eof = self.pos
        sb = _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        sb += struct.pack("<QQII", 0, hdr, 1, 0) + struct.pack("<QQ", btree, heap)
        with open(path, "wb") as f:
            f.write(sb)
            for addr, data in sorted(self.blocks, key=lambda b: b[0]):
                f.seek(addr)
                f.write(data)
            f.truncate(eof)


def write(path, root: WGroup) -> None:
    """Write ``root`` (a ``WGroup`` tree) as an HDF5 file at ``path``."""
    w = _Writer()
    entry = w.group(root)
    w.finish(path, entry)
