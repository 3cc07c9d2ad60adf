"""A minimal HDF5 reader and writer for FLASH files, in numpy.

The port reads and writes FLASH's HDF5 files without h5py (the card's
machine has no HDF5 library), through the subset of the format that
FLASH files and h5py's default output use:

* superblock version 0 or 1, 8-byte offsets and lengths;
* groups with a symbol table (v1 B-tree, symbol nodes and a local
  heap), the root and any nested below it; object headers version 1,
  with continuation blocks;
* datasets of rank >= 1 (or scalars) with contiguous or compact storage;
* fixed-point, floating-point, fixed-length string and compound
  datatypes (compound versions 1-3).

Anything else (newer superblocks or object headers, groups with
new-style link storage, chunked or filtered storage, other datatypes)
raises NotImplementedError naming it. The writer emits the same
structures: each dataset's raw data is written as it is created, and
the metadata (object headers, heaps, symbol nodes, B-trees, superblock)
when the file closes. Its files open in h5py and the HDF5 tools. Mode
"a" reads an existing file whole, lets its objects be replaced or
deleted (h5py's ``del``), and rewrites it on close: meant for small
result files.

    with File(path, "w") as f:
        f.create_dataset("dens", data=array, dtype="<f4")
        f.create_group("spectra").create_dataset("k", data=k)
    with File(path, "r") as f:
        array = f["dens"][()]
        k = f["spectra/k"][()]
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 96  # version 0 with 8-byte offsets, root entry included
_GROUP_INTERNAL_K = 16
_HEAP_FREE_NULL = 1  # "no free block" in a local heap header

# Object header message types.
_MSG_NIL, _MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL = 0x0000, 0x0001, 0x0003, 0x0005
_MSG_LAYOUT, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x0008, 0x0010, 0x0011
_MSG_FILTERS, _MSG_LINK_INFO, _MSG_LINK = 0x000B, 0x0002, 0x0006


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# Datatypes


def _decode_datatype(buf: bytes, pos: int = 0) -> Tuple[np.dtype, int]:
    """(numpy dtype, bytes used) of the datatype message at ``pos``."""
    cls_ver, b0, b1, b2, size = struct.unpack_from("<BBBBI", buf, pos)
    cls, version = cls_ver & 0x0F, cls_ver >> 4
    bits = b0 | (b1 << 8) | (b2 << 16)
    end = "<" if bits & 1 == 0 else ">"
    if cls == 0:  # fixed-point
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{end}{kind}{size}"), 12
    if cls == 1:  # floating point
        return np.dtype(f"{end}f{size}"), 20
    if cls == 3:  # fixed-length string
        return np.dtype(f"S{size}"), 8
    if cls == 6:  # compound
        nmembers = bits & 0xFFFF
        p = pos + 8
        names, formats, offsets = [], [], []
        for _ in range(nmembers):
            stop = buf.index(b"\0", p)
            names.append(buf[p:stop].decode())
            if version < 3:
                p += _pad8(stop + 1 - p)  # the name field is padded to 8 bytes
                (offset,) = struct.unpack_from("<I", buf, p)
                p += 4
                if version == 1:
                    rank = buf[p]
                    p += 28  # rank, reserved, permutation, reserved, 4 dimension sizes
                    if rank:
                        raise NotImplementedError("HDF5 compound members with array dimensions")
            else:
                p = stop + 1
                nbytes = max(1, (size.bit_length() + 7) // 8)
                offset = int.from_bytes(buf[p : p + nbytes], "little")
                p += nbytes
            member, used = _decode_datatype(buf, p)
            p += used
            formats.append(member)
            offsets.append(offset)
        dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets, "itemsize": size})
        return dtype, p - pos
    raise NotImplementedError(f"HDF5 datatype class {cls}")


_FLOAT_PROPS = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}


def _encode_datatype(dtype: np.dtype) -> bytes:
    """Datatype message for a little-endian numeric, fixed-string or
    compound numpy dtype (h5py's encodings)."""
    dtype = np.dtype(dtype)
    if dtype.names is not None:
        body = b""
        for name in dtype.names:
            member, offset = dtype.fields[name][:2]
            raw = name.encode() + b"\0"
            body += raw + b"\0" * (_pad8(len(raw)) - len(raw))
            body += struct.pack("<IB3xI4x4I", offset, 0, 0, 0, 0, 0, 0)
            body += _encode_datatype(member)
        n = len(dtype.names)
        return struct.pack("<BBBBI", 0x16, n & 0xFF, n >> 8, 0, dtype.itemsize) + body
    if dtype.byteorder == ">":
        raise NotImplementedError("writing big-endian HDF5 data")
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in _FLOAT_PROPS:
        prec, eloc, esize, mloc, msize, bias = _FLOAT_PROPS[dtype.itemsize]
        # byte order LE, no padding, implied msb mantissa; sign bit at prec-1
        head = struct.pack("<BBBBI", 0x11, 0x20, prec - 1, 0, dtype.itemsize)
        return head + struct.pack("<HHBBBBI", 0, prec, eloc, esize, mloc, msize, bias)
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dtype.itemsize)  # null-padded ASCII
    raise NotImplementedError(f"HDF5 encoding of numpy dtype {dtype}")


# ---------------------------------------------------------------------------
# Reading


class Dataset:
    """A contiguous or compact dataset: ``shape``, ``dtype``, ``[()]`` for
    the whole dataset and numpy basic indexing (``[..., x0:x1]``) for a
    part of it."""

    def __init__(self, path: Path, shape, dtype, address: int, nbytes: int, inline: Optional[bytes]):
        self._path = path
        self.shape = tuple(shape)
        self.dtype = dtype
        self._address = address
        self._nbytes = nbytes
        self._inline = inline

    def __getitem__(self, key) -> np.ndarray:
        whole = isinstance(key, tuple) and not key
        count = int(np.prod(self.shape, dtype=np.int64))
        if self._nbytes < count * self.dtype.itemsize:
            raise OSError(f"{self._path}: dataset storage smaller than its shape and type")
        if self._inline is not None:
            out = np.frombuffer(self._inline, dtype=self.dtype, count=count).copy()
        elif count == 0 or self._address == UNDEF:
            out = np.zeros(count, dtype=self.dtype)
        elif not whole:
            # A part of contiguous storage: slice a read-only map of the
            # file, so only the pages the key touches are read.
            if os.path.getsize(self._path) < self._address + count * self.dtype.itemsize:
                raise OSError(f"{self._path}: dataset data runs past the end of the file")
            view = np.memmap(self._path, dtype=self.dtype, mode="r", offset=self._address,
                             shape=self.shape)
            return np.array(view[key])
        else:
            out = np.fromfile(self._path, dtype=self.dtype, count=count, offset=self._address)
            if out.size != count:
                raise OSError(f"{self._path}: dataset data runs past the end of the file")
        out = out.reshape(self.shape)
        return out if whole else np.array(out[key])


def _split(path: str) -> Tuple[str, str]:
    """("a", "b/c") for "a/b/c": the first name of a path and the rest."""
    head, _, rest = path.strip("/").partition("/")
    return head, rest


class Group:
    """A group of a file opened for reading: a mapping of names to
    groups and datasets. Keys may be paths ("spectra/k")."""

    def __init__(self, file: "File", entries: Dict[str, Tuple[int, Optional[Tuple[int, int]]]]):
        self._file = file
        self._entries = entries  # name -> (object header, cached (B-tree, heap) of a group)

    def keys(self) -> List[str]:
        return list(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __contains__(self, path: str) -> bool:
        head, rest = _split(path)
        if head not in self._entries:
            return False
        if not rest:
            return True
        node = self[head]
        return isinstance(node, Group) and rest in node

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        head, rest = _split(path)
        header, cached = self._entries[head]
        node = self._file._node(head, header, cached)
        if not rest:
            return node
        if not isinstance(node, Group):
            raise KeyError(path)
        return node[rest]


class _Stored:
    """A dataset of a file being written: where its raw data lies, or
    (mode "a") the array still to be written."""

    def __init__(self, shape, dtype, address: int = UNDEF, nbytes: int = 0, pending=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.address = address
        self.nbytes = nbytes
        self.pending = pending


class WritableGroup:
    """A group of a file being written: ``create_dataset``,
    ``create_group`` and ``del``, as in h5py."""

    def __init__(self, file: "File"):
        self._file = file
        self._children: Dict[str, Union["WritableGroup", _Stored]] = {}

    def keys(self) -> List[str]:
        return list(self._children)

    def __iter__(self) -> Iterator[str]:
        return iter(self._children)

    def __contains__(self, path: str) -> bool:
        head, rest = _split(path)
        node = self._children.get(head)
        if node is None:
            return False
        return not rest or (isinstance(node, WritableGroup) and rest in node)

    def __getitem__(self, path: str) -> Union["WritableGroup", _Stored]:
        head, rest = _split(path)
        node = self._children[head]
        if not rest:
            return node
        if not isinstance(node, WritableGroup):
            raise KeyError(path)
        return node[rest]

    def __delitem__(self, name: str) -> None:
        """Unlink ``name``; as in h5py, data already written stays in the
        file as unused space."""
        del self._children[name]

    def _new(self, name: str, kind: str) -> None:
        if name in self._children or "/" in name or not name:
            raise ValueError(f"cannot create {kind} {name!r}")

    def create_group(self, name: str) -> "WritableGroup":
        self._new(name, "group")
        group = self._children[name] = WritableGroup(self._file)
        return group

    def create_dataset(self, name: str, data=None, dtype=None) -> None:
        """Write ``data`` (converted to ``dtype``) as a contiguous dataset."""
        self._new(name, "dataset")
        arr = np.asarray(data)
        # order="C", not np.ascontiguousarray: that turns a scalar into shape (1,).
        arr = np.asarray(arr if dtype is None else arr.astype(dtype, copy=False), order="C")
        self._children[name] = self._file._write_raw(_little_endian(arr))


class File:
    """An HDF5 file opened for reading ("r"), written anew ("w"), or
    read whole and rewritten on close ("a", created when missing)."""

    def __init__(self, path, mode: str = "r"):
        self.path = Path(path)
        self.mode = mode
        if mode == "r":
            self._fh = open(self.path, "rb")
            try:
                self._root = self._read_root()
            except BaseException:
                self._fh.close()
                raise
        elif mode in ("w", "a"):
            self._root = WritableGroup(self)
            if mode == "a" and self.path.is_file():
                with File(self.path, "r") as old:
                    _take_over(old._root, self._root)
            # "a" writes beside the file and replaces it on close.
            self._out = self.path if mode == "w" else self.path.with_name(self.path.name + ".tmp")
            self._fh = open(self._out, "wb")
            self._fh.write(b"\0" * _SUPERBLOCK_SIZE)
        else:
            raise ValueError(f"mode must be 'r', 'w' or 'a', not {mode!r}")

    # -- context and mapping protocol -----------------------------------
    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._fh.closed:
            return
        try:
            if self.mode != "r":
                self._finish()
        finally:
            self._fh.close()
        if self.mode == "a":
            os.replace(self._out, self.path)

    def keys(self) -> List[str]:
        return self._root.keys()

    def __iter__(self) -> Iterator[str]:
        return iter(self._root)

    def __contains__(self, path: str) -> bool:
        return path in self._root

    def __getitem__(self, path: str):
        return self._root[path]

    def __delitem__(self, name: str) -> None:
        del self._root[name]

    def create_group(self, name: str) -> WritableGroup:
        if self.mode == "r":
            raise ValueError("create_group needs a file opened with mode 'w' or 'a'")
        return self._root.create_group(name)

    def create_dataset(self, name: str, data=None, dtype=None) -> None:
        if self.mode == "r":
            raise ValueError("create_dataset needs a file opened with mode 'w' or 'a'")
        self._root.create_dataset(name, data=data, dtype=dtype)

    # -- reading ----------------------------------------------------------
    def _read(self, address: int, size: int) -> bytes:
        self._fh.seek(address)
        data = self._fh.read(size)
        if len(data) != size:
            raise OSError(f"{self.path}: truncated HDF5 file")
        return data

    def _read_root(self) -> Group:
        head = self._read(0, 24)
        if head[:8] != SIGNATURE:
            raise OSError(f"{self.path}: not an HDF5 file (no signature at offset 0)")
        version = head[8]
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if head[13] != 8 or head[14] != 8:
            raise NotImplementedError("HDF5 offsets or lengths other than 8 bytes")
        root = 24 + (4 if version == 1 else 0) + 32
        _name, header, _cache = struct.unpack("<QQI", self._read(root, 20))
        messages = self._messages(header)
        if _MSG_SYMBOL_TABLE not in messages:
            raise NotImplementedError("HDF5 root group without a symbol table")
        return Group(self, self._group_entries(*struct.unpack_from("<QQ", messages[_MSG_SYMBOL_TABLE])))

    def _group_entries(self, btree: int, heap: int):
        entries: Dict[str, Tuple[int, Optional[Tuple[int, int]]]] = {}
        self._walk_btree(btree, self._heap(heap), entries)
        return entries

    def _node(self, name: str, header: int, cached: Optional[Tuple[int, int]]):
        """The group or dataset whose object header is at ``header``."""
        if cached is not None:
            return Group(self, self._group_entries(*cached))
        if self._read(header, 4) == b"OHDR":
            raise NotImplementedError(
                f"HDF5 object {name!r} has a version 2 object header (a nested group "
                "with new-style link storage, or a newer dataset layout)"
            )
        messages = self._messages(header)
        if _MSG_SYMBOL_TABLE in messages:
            return Group(self, self._group_entries(*struct.unpack_from("<QQ", messages[_MSG_SYMBOL_TABLE])))
        if _MSG_LINK in messages or _MSG_LINK_INFO in messages:
            raise NotImplementedError(f"HDF5 nested group {name!r} with new-style link storage")
        return self._dataset(messages)

    def _heap(self, address: int) -> bytes:
        hdr = self._read(address, 32)
        if hdr[:4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap signature")
        size, _free, data = struct.unpack_from("<QQQ", hdr, 8)
        return self._read(data, size)

    def _walk_btree(self, address: int, names: bytes, entries) -> None:
        hdr = self._read(address, 24)
        if hdr[:4] != b"TREE" or hdr[4] != 0:
            raise OSError(f"{self.path}: bad group B-tree node")
        level, used = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
        body = self._read(address + 24, 16 * used + 8)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
        for child in children:
            if level > 0:
                self._walk_btree(child, names, entries)
                continue
            snod = self._read(child, 8)
            if snod[:4] != b"SNOD":
                raise OSError(f"{self.path}: bad symbol table node")
            count = struct.unpack_from("<H", snod, 6)[0]
            table = self._read(child + 8, 40 * count)
            for i in range(count):
                name_off, header, cache = struct.unpack_from("<QQI", table, 40 * i)
                name = names[name_off : names.index(b"\0", name_off)].decode()
                # Cache type 1: a group, its B-tree and heap in the scratch pad.
                cached = struct.unpack_from("<QQ", table, 40 * i + 24) if cache == 1 else None
                entries[name] = (header, cached)

    def _messages(self, address: int) -> Dict[int, bytes]:
        """Messages of a version-1 object header, continuation blocks included."""
        prefix = self._read(address, 16)
        if prefix[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {prefix[0]}")
        nmesgs, _refs, size = struct.unpack_from("<HII", prefix, 2)
        chunks = [(address + 16, size)]
        out: Dict[int, bytes] = {}
        seen = 0
        while chunks and seen < nmesgs:
            start, length = chunks.pop(0)
            buf = self._read(start, length)
            pos = 0
            while pos + 8 <= length and seen < nmesgs:
                mtype, msize = struct.unpack_from("<HH", buf, pos)
                data = buf[pos + 8 : pos + 8 + msize]
                seen += 1
                if mtype == _MSG_CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", data))
                elif mtype != _MSG_NIL:
                    out.setdefault(mtype, data)
                pos += 8 + msize
        return out

    def _dataset(self, msgs: Dict[int, bytes]) -> Dataset:
        if _MSG_FILTERS in msgs:
            raise NotImplementedError("filtered (compressed) HDF5 datasets")
        space = msgs[_MSG_DATASPACE]
        version, rank, flags = space[0], space[1], space[2]
        start = 8 if version == 1 else 4
        if version == 2 and space[3] == 2:
            rank = 0
        shape = struct.unpack_from(f"<{rank}Q", space, start)
        dtype, _ = _decode_datatype(msgs[_MSG_DATATYPE])
        layout = msgs[_MSG_LAYOUT]
        if layout[0] not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout message version {layout[0]}")
        if layout[1] == 1:  # contiguous
            address, nbytes = struct.unpack_from("<QQ", layout, 2)
            return Dataset(self.path, shape, dtype, address, nbytes, None)
        if layout[1] == 0:  # compact
            (nbytes,) = struct.unpack_from("<H", layout, 2)
            return Dataset(self.path, shape, dtype, UNDEF, nbytes, bytes(layout[4 : 4 + nbytes]))
        raise NotImplementedError("chunked HDF5 datasets")

    # -- writing ----------------------------------------------------------
    def _write_raw(self, arr: np.ndarray) -> _Stored:
        address = self._fh.tell() if arr.nbytes else UNDEF
        if arr.nbytes:
            arr.tofile(self._fh)
        return _Stored(arr.shape, arr.dtype, address, arr.nbytes)

    def _put(self, data: bytes) -> int:
        address = self._fh.tell()
        self._fh.write(data)
        return address

    @staticmethod
    def _object_header(messages: List[Tuple[int, bytes]]) -> bytes:
        body = b""
        for mtype, data in messages:
            padded = data + b"\0" * (_pad8(len(data)) - len(data))
            body += struct.pack("<HHB3x", mtype, len(padded), 0) + padded
        return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body

    def _dataset_header(self, node: _Stored) -> int:
        shape = node.shape
        space = struct.pack("<BBB5x", 1, len(shape), 0) + struct.pack(f"<{len(shape)}Q", *shape)
        fill = struct.pack("<BBBB", 2, 2, 2, 0)  # late allocation, write if set, undefined
        layout = struct.pack("<BBQQ", 3, 1, node.address, node.nbytes)
        return self._put(
            self._object_header(
                [(_MSG_DATASPACE, space), (_MSG_DATATYPE, _encode_datatype(node.dtype)),
                 (_MSG_FILL, fill), (_MSG_LAYOUT, layout)]
            )
        )

    def _group_metadata(self, group: WritableGroup, leaf_k: int) -> Tuple[int, int, int]:
        """Write a group's members' headers, then its heap, symbol node,
        B-tree and header: (header, B-tree, heap) addresses."""
        names = sorted(group._children, key=lambda n: n.encode())
        entries = []
        for name in names:
            node = group._children[name]
            if isinstance(node, WritableGroup):
                entries.append((name, 1, *self._group_metadata(node, leaf_k)))
            else:
                entries.append((name, 0, self._dataset_header(node), 0, 0))
        # Local heap: "" at offset 0, then each name, null-terminated, 8-aligned.
        heap, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap)
            raw = name.encode() + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_data = self._put(bytes(heap))
        heap_hdr = struct.pack("<B3xQQQ", 0, len(heap), _HEAP_FREE_NULL, heap_data)
        heap_addr = self._put(b"HEAP" + heap_hdr)
        # One symbol node holds every entry: the leaf K is sized for the largest group.
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
        for name, cache, header, tree, sub_heap in entries:
            snod += struct.pack("<QQI4xQQ", offsets[name], header, cache, tree, sub_heap)
        snod_addr = self._put(snod + b"\0" * (40 * 2 * leaf_k - 40 * len(names)))
        last_key = offsets[names[-1]] if names else 0
        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
        tree += struct.pack("<QQQ", 0, snod_addr, last_key)
        node_size = 24 + 8 * (2 * _GROUP_INTERNAL_K + 1) + 8 * 2 * _GROUP_INTERNAL_K
        tree_addr = self._put(tree + b"\0" * (node_size - len(tree)))
        symbols = struct.pack("<QQ", tree_addr, heap_addr)
        header = self._put(self._object_header([(_MSG_SYMBOL_TABLE, symbols)]))
        return header, tree_addr, heap_addr

    def _finish(self) -> None:
        groups = [self._root]
        for group in groups:  # grows while it is walked: every group, breadth first
            for node in group._children.values():
                if isinstance(node, WritableGroup):
                    groups.append(node)
                elif node.pending is not None:
                    written = self._write_raw(node.pending)
                    node.address, node.nbytes, node.pending = written.address, written.nbytes, None
        leaf_k = max(4, (max(len(g._children) for g in groups) + 1) // 2)
        root, tree_addr, heap_addr = self._group_metadata(self._root, leaf_k)
        eof = self._fh.tell()
        superblock = SIGNATURE + struct.pack(
            "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, _GROUP_INTERNAL_K, 0
        )
        superblock += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        superblock += struct.pack("<QQI4xQQ", 0, root, 1, tree_addr, heap_addr)
        assert len(superblock) == _SUPERBLOCK_SIZE
        self._fh.seek(0)
        self._fh.write(superblock)


def _take_over(src: Group, dst: WritableGroup) -> None:
    """Copy a group read from a file into a group to be written, the
    arrays held in memory until the new file is written."""
    for name in src:
        node = src[name]
        if isinstance(node, Group):
            _take_over(node, dst.create_group(name))
        else:
            arr = _little_endian(node[()])
            dst._children[name] = _Stored(arr.shape, arr.dtype, pending=arr)


def _little_endian(arr: np.ndarray) -> np.ndarray:
    """``arr`` in little-endian byte order, its type checked for the writer."""
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    _encode_datatype(arr.dtype)  # refuse unsupported types before writing
    return arr
