"""A frozen copy of the port's io/h5read.py: a read-only HDF5 reader for the files Keras writes (``model.weights.h5``
inside a ``.keras`` archive), with numpy and ``struct`` only.

Keras saves weights through h5py with its default, earliest file format:

- superblock version 0 (version 1 reads the same way);
- version-1 object headers, continued in further blocks;
- groups as symbol tables: a version-1 B-tree of group nodes (of any
  depth) over SNOD symbol nodes, the names in a local heap;
- datasets with a dataspace, a little-endian IEEE float or an integer
  datatype, and contiguous (or compact) storage.

``read_h5`` returns the tree as nested dicts, group name -> dict or
``Dataset(array, offset, header)``, where ``offset`` is the byte offset of
the dataset's raw data in the file (None for an empty dataset) and
``header`` the address of its object header; ``object_messages`` and
``superblock`` give the positions a writer rewrites in place. Everything else
raises ``ValueError`` naming the HDF5 feature: chunked or filtered storage,
superblocks 2 and 3, version-2 object headers, link-message groups,
big-endian data, and string, variable-length or compound types.
"""

import struct
from typing import NamedTuple, Optional

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UINT = {1: "B", 2: "H", 4: "I", 8: "Q"}

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _LAYOUT, _EXTERNAL = 0x01, 0x02, 0x03, 0x08, 0x07
_LINK, _GROUP_INFO, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x06, 0x0A, 0x0B, 0x10, 0x11

# IEEE layouts of the float datatype message: size -> (precision, exponent
# location, exponent size, mantissa location, mantissa size, bias)
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
_TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
_MAX_DEPTH = 64


class Dataset(NamedTuple):
    array: np.ndarray
    offset: Optional[int]  # byte offset of the raw data in the file
    header: Optional[int] = None  # address of the object header


class Superblock(NamedTuple):
    base: int  # base address: file addresses are relative to it
    so: int  # size of offsets
    sl: int  # size of lengths
    eof_at: int  # byte offset of the end-of-file address field


def superblock(buf) -> Superblock:
    """The superblock fields a writer needs, of the HDF5 file in `buf`."""
    f = _File(bytes(buf))
    return Superblock(f.base, f.so, f.sl, f.eof_at)


def object_messages(buf, header):
    """[(message type, byte offset of the message data, size)] of the
    object header at address `header`, continuation blocks followed."""
    return _File(bytes(buf))._messages(header)


def read_h5(buf) -> dict:
    """The whole tree of an HDF5 file held in `buf` (bytes-like)."""
    try:
        return _File(bytes(buf)).root()
    except (struct.error, IndexError) as e:
        raise ValueError(f"truncated or malformed HDF5 file ({e})") from None


class _File:
    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file at offset 0 (user blocks are not supported)")
        version = buf[8]
        if version not in (0, 1):
            raise ValueError(f"HDF5 superblock version {version} is not supported (0 and 1 are)")
        self.so, self.sl = buf[13], buf[14]  # sizes of offsets and of lengths
        if self.so not in _UINT or self.sl not in _UINT:
            raise ValueError(f"HDF5 offset/length sizes {self.so}/{self.sl} are not supported")
        pos = 24 if version == 0 else 28
        self.base = self._uint(pos, self.so)
        self.eof_at = pos + 2 * self.so
        pos += 4 * self.so  # the base address and three more (free space, end of file, I/O info)
        self.root_header = self._uint(pos + self.so, self.so)  # root symbol table entry

    # -- primitives ---------------------------------------------------------

    def _uint(self, pos, size):
        return struct.unpack_from("<" + _UINT[size], self.buf, pos)[0]

    def _undefined(self, addr):
        return addr == (1 << (8 * self.so)) - 1

    def _at(self, addr):
        """An address of the file as a position in the buffer."""
        return self.base + addr

    # -- object headers -----------------------------------------------------

    def _messages(self, addr):
        """[(type, position of the message data, size)] of the object
        header at `addr`, continuation blocks followed."""
        pos = self._at(addr)
        if self.buf[pos : pos + 4] == b"OHDR":
            raise ValueError("HDF5 version-2 object headers are not supported")
        if self.buf[pos] != 1:
            raise ValueError(f"HDF5 object header version {self.buf[pos]} is not supported")
        n_messages = self._uint(pos + 2, 2)
        blocks = [(pos + 16, self._uint(pos + 8, 4))]
        out = []
        while blocks and len(out) < n_messages:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and len(out) < n_messages:
                mtype, msize, flags = struct.unpack_from("<HHB", self.buf, p)
                if flags & 0x02:
                    raise ValueError("HDF5 shared object header messages are not supported")
                data = p + 8
                if mtype == _CONTINUATION:
                    blocks.append((self._at(self._uint(data, self.so)),
                                   self._uint(data + self.so, self.sl)))
                out.append((mtype, data, msize))
                p = data + msize
        return out

    def _object(self, addr, depth):
        if depth > _MAX_DEPTH:
            raise ValueError("HDF5 groups nested too deeply")
        msgs = {}
        for mtype, data, size in self._messages(addr):
            msgs.setdefault(mtype, (data, size))
        if _LINK_INFO in msgs or _LINK in msgs or _GROUP_INFO in msgs:
            raise ValueError("HDF5 link-message (new-style) groups are not supported")
        if _SYMBOL_TABLE in msgs:
            data = msgs[_SYMBOL_TABLE][0]
            btree = self._uint(data, self.so)
            heap = self._uint(data + self.so, self.so)
            return {name: self._object(child, depth + 1)
                    for name, child in self._group_entries(btree, heap)}
        if _LAYOUT in msgs:
            return self._dataset(msgs)._replace(header=addr)
        raise ValueError("HDF5 object is neither a symbol-table group nor a dataset")

    # -- groups -------------------------------------------------------------

    def _heap_data(self, heap):
        pos = self._at(heap)
        if self.buf[pos : pos + 4] != b"HEAP":
            raise ValueError("HDF5 local heap signature missing")
        return self._at(self._uint(pos + 8 + 2 * self.sl, self.so))

    def _name(self, heap_data, offset):
        start = heap_data + offset
        end = self.buf.index(b"\0", start)
        return self.buf[start:end].decode("utf-8")

    def _group_entries(self, btree, heap):
        """(name, object header address) of every link of a symbol-table
        group, in B-tree (name) order."""
        heap_data = self._heap_data(heap)
        entries, seen = [], set()
        entry_size = 2 * self.so + 24

        def node(addr, depth):
            if addr in seen or depth > _MAX_DEPTH:
                raise ValueError("HDF5 group B-tree has a cycle")
            seen.add(addr)
            pos = self._at(addr)
            if self.buf[pos : pos + 4] != b"TREE":
                raise ValueError("HDF5 B-tree node signature missing")
            if self.buf[pos + 4] != 0:
                raise ValueError("HDF5 B-tree node is not a group node")
            level, used = self.buf[pos + 5], self._uint(pos + 6, 2)
            p = pos + 8 + 2 * self.so + self.sl  # siblings, then the first key
            for _ in range(used):
                child = self._uint(p, self.so)
                p += self.so + self.sl
                if level:
                    node(child, depth + 1)
                else:
                    snod(child)

        def snod(addr):
            pos = self._at(addr)
            if self.buf[pos : pos + 4] != b"SNOD":
                raise ValueError("HDF5 symbol table node signature missing")
            for i in range(self._uint(pos + 6, 2)):
                e = pos + 8 + i * entry_size
                name = self._name(heap_data, self._uint(e, self.so))
                entries.append((name, self._uint(e + self.so, self.so)))

        node(btree, 0)
        return entries

    # -- datasets -----------------------------------------------------------

    def _dataset(self, msgs):
        if _FILTERS in msgs:
            raise ValueError("HDF5 filtered (compressed) datasets are not supported")
        if _EXTERNAL in msgs:
            raise ValueError("HDF5 external storage is not supported")
        if _DATASPACE not in msgs or _DATATYPE not in msgs:
            raise ValueError("HDF5 dataset without a dataspace or datatype")
        shape = self._dataspace(msgs[_DATASPACE][0])
        dtype = self._datatype(msgs[_DATATYPE][0])
        count = int(np.prod(shape, dtype=np.int64))
        pos = self._layout(msgs[_LAYOUT][0], count * dtype.itemsize)
        if pos is None:
            return Dataset(np.zeros(shape, dtype), None)
        if pos + count * dtype.itemsize > len(self.buf):
            raise ValueError("HDF5 dataset runs past the end of the file")
        arr = np.frombuffer(self.buf, dtype, count, offset=pos).reshape(shape).copy()
        return Dataset(arr, pos)

    def _dataspace(self, p):
        version, rank, flags = self.buf[p], self.buf[p + 1], self.buf[p + 2]
        if version == 1:
            dims = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:  # null dataspace
                return (0,)
            dims = p + 4
        else:
            raise ValueError(f"HDF5 dataspace version {version} is not supported")
        return tuple(self._uint(dims + i * self.sl, self.sl) for i in range(rank))

    def _datatype(self, p):
        cls, version = self.buf[p] & 0x0F, self.buf[p] >> 4
        bits = self.buf[p + 1]
        size = self._uint(p + 4, 4)
        if cls == 0:  # fixed-point
            if bits & 0x01:
                raise ValueError("HDF5 big-endian data is not supported")
            offset, precision = struct.unpack_from("<HH", self.buf, p + 8)
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                raise ValueError(f"HDF5 integer of {size} bytes, {precision} bits at "
                                 f"bit {offset} is not supported")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:  # floating point
            if bits & 0x41:
                raise ValueError("HDF5 big-endian (or VAX-order) data is not supported")
            layout = struct.unpack_from("<HHBBBBI", self.buf, p + 8)[1:]
            if _IEEE.get(size) != tuple(layout):
                raise ValueError(f"HDF5 float of {size} bytes is not IEEE binary{8 * size}")
            return np.dtype(f"<f{size}")
        name = _TYPE_CLASSES.get(cls, f"class {cls}")
        raise ValueError(f"HDF5 {name} datatype (version {version}) is not supported")

    def _layout(self, p, nbytes):
        """Position of a dataset's raw data in the buffer (None when it has
        no storage and no elements)."""
        version = self.buf[p]
        if version in (1, 2):
            rank, cls = self.buf[p + 1], self.buf[p + 2]
            if cls == 0:  # compact: the dimension sizes, then size and data
                return p + 8 + 4 * rank + 4
            if cls != 1:
                raise ValueError("HDF5 chunked storage is not supported")
            addr = self._uint(p + 8, self.so)
        elif version in (3, 4):
            cls = self.buf[p + 1]
            if cls == 0:
                return p + 4
            if cls != 1:
                raise ValueError("HDF5 chunked or virtual storage is not supported")
            addr = self._uint(p + 2, self.so)
        else:
            raise ValueError(f"HDF5 data layout version {version} is not supported")
        if self._undefined(addr):
            if nbytes:
                raise ValueError("HDF5 dataset has elements but no storage")
            return None
        return self._at(addr)

    def root(self):
        return self._object(self.root_header, 0)
