"""A read-only HDF5 reader in numpy, ``struct`` and ``zlib``.

The grackle data files (``CloudyData_UVB=HM2012.h5`` and the rest) are
HDF5.  This module reads them on a machine without h5py or libhdf5, which
is the card's machine: it implements the part of the HDF5 file format
(the HDF Group's "HDF5 File Format Specification", version 3) that such
files and files written by h5py use, and the small part of h5py's surface
that ``data/cloudy.py`` and ``data/uvb.py`` call:

* ``File(path)`` as a context manager; ``f["/a/b"]`` gives a
  :class:`Group` or a :class:`Dataset`;
* ``Group.items()`` / ``keys()`` / ``in`` / ``len``, in name order;
* ``.attrs`` on files, groups and datasets: a dict of numpy values (a
  numpy scalar for a scalar attribute, ``str`` for a variable-length
  string, as h5py gives them);
* ``dset[...]`` and ``dset[()]``: a new numpy array in native byte order,
  or for a scalar dataset ``[()]`` gives a numpy scalar (``bytes`` for a
  variable-length string).

Supported: superblock versions 0-3 with 4- or 8-byte offsets and lengths;
object headers v1 and v2 with continuation blocks (checksums not
verified); groups as a symbol table (v1 B-tree, ``SNOD``, local heap) or
as compact link messages (hard links); dataspaces v1 and v2 (scalars
included); fixed-point and IEEE floating-point data of either byte order,
fixed-length strings and variable-length strings (global heap);
attribute messages v1-v3; data layout v3 (compact, contiguous, chunked
with a v1 B-tree, partial edge chunks) and v4 (compact, contiguous); the
filter pipeline v1 and v2 with deflate, shuffle and fletcher32 (the
checksum verified and stripped).

Anything else raises ``NotImplementedError`` naming the feature and the
file -- dense link or attribute storage (fractal heaps), the chunk indexes
of layout v4, other filters, external or virtual storage, soft and
external links, shared messages, other datatype classes -- and so does a
dataset whose storage was never written (its fill value is not read).
It never returns a guess.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_MSG_NIL = 0x00
_MSG_DATASPACE = 0x01
_MSG_LINK_INFO = 0x02
_MSG_DATATYPE = 0x03
_MSG_LINK = 0x06
_MSG_EXTERNAL = 0x07
_MSG_LAYOUT = 0x08
_MSG_FILTERS = 0x0B
_MSG_ATTRIBUTE = 0x0C
_MSG_CONTINUATION = 0x10
_MSG_SYMBOL_TABLE = 0x11
_MSG_ATTRIBUTE_INFO = 0x15
#: message flag bits: shared; and "fail if the type is unknown"
_FLAG_SHARED = 0x02
_FLAG_FAIL_IF_UNKNOWN = 0x80
#: the types whose content this reader interprets (a shared one of these
#: is stored elsewhere, which this reader does not follow)
_INTERPRETED = {_MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE, _MSG_LINK,
                _MSG_EXTERNAL, _MSG_LAYOUT, _MSG_FILTERS, _MSG_ATTRIBUTE,
                _MSG_CONTINUATION, _MSG_SYMBOL_TABLE, _MSG_ATTRIBUTE_INFO}
#: the types a reader may ignore: fill values, group info, comments,
#: modification times, B-tree K values, reference counts
_IGNORABLE = {_MSG_NIL, 0x04, 0x05, 0x0A, 0x0D, 0x0E, 0x12, 0x13, 0x16}

_FILTER_DEFLATE = 1
_FILTER_SHUFFLE = 2
_FILTER_FLETCHER32 = 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset"}

#: IEEE layouts by size: (exponent location, exponent size, mantissa
#: location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}


class _Cursor:
    """Little-endian fields read in order from a bytes object."""

    def __init__(self, data, pos, sizes):
        self.data = data
        self.pos = pos
        self.offset_size, self.length_size = sizes

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("HDF5 structure runs past its block")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "little")

    def u8(self):
        return self.uint(1)

    def u16(self):
        return self.uint(2)

    def u32(self):
        return self.uint(4)

    def offset(self):
        return self.uint(self.offset_size)

    def length(self):
        return self.uint(self.length_size)

    def skip(self, n):
        self.take(n)


def _pad8(n):
    return (n + 7) & ~7


def _fletcher32(data) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words summed in blocks of 360, each block's sums folded to 16 bits."""
    n_words = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n_words).astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, n_words, 360):
        block = words[start:start + 360]
        running = np.cumsum(block)
        sum2 += len(block) * sum1 + int(running.sum())
        sum1 += int(running[-1])
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


class _VlenString:
    """A variable-length string datatype: each element is a length, a
    global heap collection address and an object index."""

    def __init__(self, charset):
        self.charset = charset


class _Reader:
    """The open file: its superblock's sizes and raw reads relative to
    its base address."""

    def __init__(self, path):
        self.path = str(path)
        self.fh = open(path, "rb")
        try:
            self._superblock()
        except BaseException:
            self.fh.close()
            raise
        self._heaps = {}

    def unsupported(self, feature):
        return NotImplementedError(
            f"{self.path}: {feature} is not supported by "
            f"grackle_tpu_torch.data.h5read")

    def _superblock(self):
        size = self.fh.seek(0, 2)
        base = 0
        while True:
            if base + 8 > size:
                raise ValueError(f"{self.path}: not an HDF5 file")
            self.fh.seek(base)
            if self.fh.read(8) == _SIGNATURE:
                break
            base = 512 if base == 0 else 2 * base
        self.fh.seek(base)
        head = self.fh.read(128)
        version = head[8]
        if version in (0, 1):
            sizes = (head[13], head[14])
            pos = 24 if version == 0 else 28
        elif version in (2, 3):
            sizes = (head[9], head[10])
            pos = 12
        else:
            raise self.unsupported(f"superblock version {version}")
        if sizes[0] not in (4, 8) or sizes[1] not in (4, 8):
            raise self.unsupported(f"offsets of {sizes[0]} and lengths of "
                                   f"{sizes[1]} bytes")
        self.offset_size, self.length_size = sizes
        self.undefined = (1 << (8 * self.offset_size)) - 1
        c = self.cursor(head, pos)
        base_address = c.offset()
        if version in (0, 1):
            c.skip(3 * self.offset_size)  # free-space, end-of-file, VFD info
            c.skip(self.offset_size)  # root entry: link name offset
            self.root = c.offset()
        else:
            c.skip(2 * self.offset_size)  # extension, end of file
            self.root = c.offset()
        self.base = base_address

    def cursor(self, data, pos=0):
        return _Cursor(data, pos, (self.offset_size, self.length_size))

    def read(self, address, n):
        if address == self.undefined:
            raise ValueError(f"{self.path}: read at an undefined address")
        self.fh.seek(self.base + address)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at {address}")
        return data

    # -- object headers ---------------------------------------------------

    def messages(self, address):
        """Every message of the object header at ``address`` as
        ``(type, flags, body)``, continuation blocks followed."""
        prefix = self.read(address, 16)
        blocks, out = [], []
        if prefix[:4] == b"OHDR":
            if prefix[4] != 2:
                raise self.unsupported(f"object header version {prefix[4]}")
            flags = prefix[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10
                                                     else 0)
            width = 1 << (flags & 3)
            head = self.read(address, pos + width)
            size = int.from_bytes(head[pos:pos + width], "little")
            start = pos + width
            blocks.append(self.read(address + start, size))
            version = 2
            crt_order = bool(flags & 0x04)
        elif prefix[0] == 1:
            size = int.from_bytes(prefix[8:12], "little")
            blocks.append(self.read(address + 16, size))
            version = 1
        else:
            raise self.unsupported(f"object header version {prefix[0]}")
        while blocks:
            block = blocks.pop(0)
            c = self.cursor(block)
            header = 8 if version == 1 else 4 + 2 * crt_order
            while c.pos + header <= len(block):
                if version == 1:
                    mtype, size, mflags = c.u16(), c.u16(), c.u8()
                    c.skip(3)
                else:
                    mtype, size, mflags = c.u8(), c.u16(), c.u8()
                    if crt_order:
                        c.skip(2)
                body = c.take(size)
                if mtype == _MSG_CONTINUATION:
                    cc = self.cursor(body)
                    where, length = cc.offset(), cc.length()
                    data = self.read(where, length)
                    if version == 2:
                        if data[:4] != b"OCHK":
                            raise ValueError(f"{self.path}: bad object "
                                             f"header continuation")
                        data = data[4:-4]  # signature, checksum
                    blocks.append(data)
                    continue
                if mtype in _INTERPRETED and mflags & _FLAG_SHARED:
                    raise self.unsupported(f"shared object header message "
                                           f"(type {mtype:#x})")
                if (mtype not in _INTERPRETED and mtype not in _IGNORABLE
                        and mflags & _FLAG_FAIL_IF_UNKNOWN):
                    raise self.unsupported(f"object header message type "
                                           f"{mtype:#x}")
                out.append((mtype, mflags, body))
        return out

    # -- messages ---------------------------------------------------------

    def dataspace(self, body):
        """The shape; () for a scalar."""
        c = self.cursor(body)
        version = c.u8()
        if version == 1:
            rank, flags = c.u8(), c.u8()
            c.skip(5)
        elif version == 2:
            rank, flags, kind = c.u8(), c.u8(), c.u8()
            if kind == 2:
                raise self.unsupported("null dataspace")
        else:
            raise self.unsupported(f"dataspace version {version}")
        if flags & 2:
            raise self.unsupported("dataspace permutation indices")
        return tuple(c.length() for _ in range(rank))

    def datatype(self, body):
        """(numpy dtype or _VlenString, element size in the file)."""
        c = self.cursor(body)
        class_version = c.u8()
        cls = class_version & 0x0F
        bits = c.u8() | c.u8() << 8 | c.u8() << 16
        size = c.u32()
        order = ">" if bits & 1 else "<"
        if cls == 0:
            offset, precision = c.u16(), c.u16()
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise self.unsupported(f"{size}-byte fixed-point type of "
                                       f"{precision} bits at {offset}")
            kind = "i" if bits & 0x08 else "u"
            return np.dtype(f"{order}{kind}{size}"), size
        if cls == 1:
            layout = (c.u16(), c.u16(), c.u8(), c.u8(), c.u8(), c.u8(),
                      c.u32())
            sign = (bits >> 8) & 0xFF
            ieee = size in _IEEE and layout == (0, 8 * size) + _IEEE[size]
            if bits & 0x40 or not ieee or sign != 8 * size - 1 \
                    or (bits >> 4) & 3 != 2:
                raise self.unsupported(f"{size}-byte floating-point type "
                                       f"that is not IEEE")
            return np.dtype(f"{order}f{size}"), size
        if cls == 3:
            return np.dtype(f"S{size}"), size
        if cls == 9:
            if bits & 0x0F != 1:
                raise self.unsupported("variable-length sequence type")
            return _VlenString((bits >> 8) & 0x0F), size
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 10: "array"}
        raise self.unsupported(f"{names.get(cls, cls)} datatype")

    def global_heap_object(self, collection, index):
        heap = self._heaps.get(collection)
        if heap is None:
            head = self.read(collection, 8 + self.length_size)
            if head[:4] != b"GCOL":
                raise ValueError(f"{self.path}: bad global heap collection")
            size = int.from_bytes(head[8:], "little")
            data = self.read(collection, size)
            c = self.cursor(data, 8 + self.length_size)
            heap = {}
            while c.pos + 8 + self.length_size <= len(data):
                obj_index = c.u16()
                c.skip(6)  # reference count, reserved
                obj_size = c.length()
                if obj_index == 0:  # free space: the end of the objects
                    break
                heap[obj_index] = bytes(c.take(obj_size))
                c.skip(_pad8(obj_size) - obj_size)
            self._heaps[collection] = heap
        return heap[index]

    def decode(self, raw, dtype, shape, as_str=False):
        """Elements stored as ``raw`` as a new native-order array."""
        count = int(np.prod(shape, dtype=np.int64))
        if isinstance(dtype, _VlenString):
            c = self.cursor(raw)
            out = np.empty(count, dtype=object)
            for i in range(count):
                length, collection, index = c.u32(), c.offset(), c.u32()
                val = (self.global_heap_object(collection, index)[:length]
                       if collection != self.undefined and length else b"")
                out[i] = val.decode("utf-8" if dtype.charset else "ascii") \
                    if as_str else val
            return out.reshape(shape)
        arr = np.frombuffer(raw, dtype, count=count).reshape(shape)
        return arr.astype(dtype.newbyteorder("="))

    def attribute(self, body):
        """(name, value) of an attribute message."""
        c = self.cursor(body)
        version = c.u8()
        if version not in (1, 2, 3):
            raise self.unsupported(f"attribute message version {version}")
        flags = c.u8()
        if flags & 3:
            raise self.unsupported("attribute with a shared datatype or "
                                   "dataspace")
        name_size, type_size, space_size = c.u16(), c.u16(), c.u16()
        if version == 3:
            c.skip(1)  # the name's character set
        pad = _pad8 if version == 1 else (lambda n: n)
        name = bytes(c.take(pad(name_size))[:name_size]).rstrip(b"\0")
        dtype, itemsize = self.datatype(c.take(pad(type_size)))
        shape = self.dataspace(c.take(pad(space_size)))
        count = int(np.prod(shape, dtype=np.int64))
        value = self.decode(c.take(count * itemsize), dtype, shape,
                            as_str=True)
        return name.decode("utf-8"), value[()] if shape == () else value

    # -- groups -----------------------------------------------------------

    def _local_heap(self, address):
        head = self.read(address, 8 + 2 * self.length_size
                         + self.offset_size)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap")
        c = self.cursor(head, 8)
        size = c.length()
        c.length()  # free list
        return self.read(c.offset(), size)

    def _btree_node(self, address, node_type, key_size):
        """(level, [keys], [children]) of a v1 B-tree node."""
        head = self.read(address, 8 + 2 * self.offset_size)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"{self.path}: bad v1 B-tree node")
        level = head[5]
        entries = int.from_bytes(head[6:8], "little")
        body = self.read(address + len(head),
                         entries * (key_size + self.offset_size) + key_size)
        c = self.cursor(body)
        keys, children = [], []
        for _ in range(entries):
            keys.append(c.take(key_size))
            children.append(c.offset())
        return level, keys, children

    def symbol_table_links(self, body):
        """{name: object header address} of a symbol-table group."""
        c = self.cursor(body)
        btree, heap_address = c.offset(), c.offset()
        heap = self._local_heap(heap_address)
        links = {}
        pending = [btree]
        entry_size = 2 * self.offset_size + 24
        while pending:
            level, _, children = self._btree_node(pending.pop(), 0,
                                                  self.length_size)
            if level > 0:
                pending.extend(children)
                continue
            for snod in children:
                head = self.read(snod, 8)
                if head[:4] != b"SNOD":
                    raise ValueError(f"{self.path}: bad symbol table node")
                count = int.from_bytes(head[6:8], "little")
                entries = self.cursor(self.read(snod + 8,
                                                count * entry_size))
                for _ in range(count):
                    name_offset, header = entries.offset(), entries.offset()
                    cache_type = entries.u32()
                    entries.skip(20)
                    if cache_type == 2:
                        raise self.unsupported("soft link")
                    end = heap.index(b"\0", name_offset)
                    links[heap[name_offset:end].decode("utf-8")] = header
        return links

    def link(self, body):
        """(name, object header address) of a link message."""
        c = self.cursor(body)
        version, flags = c.u8(), c.u8()
        if version != 1:
            raise self.unsupported(f"link message version {version}")
        link_type = c.u8() if flags & 0x08 else 0
        if flags & 0x04:
            c.skip(8)  # creation order
        if flags & 0x10:
            c.skip(1)  # the name's character set
        name = bytes(c.take(c.uint(1 << (flags & 3)))).decode("utf-8")
        if link_type != 0:
            kind = {1: "soft link", 64: "external link"}.get(
                link_type, f"link type {link_type}")
            raise self.unsupported(kind)
        return name, c.offset()

    # -- chunked storage --------------------------------------------------

    def chunks(self, btree, rank):
        """(offsets, stored size, filter mask, address) of each chunk
        indexed by the v1 B-tree (type 1) at ``btree``."""
        key_size = 8 + 8 * (rank + 1)
        pending = [btree]
        while pending:
            level, keys, children = self._btree_node(pending.pop(), 1,
                                                     key_size)
            if level > 0:
                pending.extend(children)
                continue
            for key, child in zip(keys, children):
                size, mask = struct.unpack_from("<II", key)
                offsets = struct.unpack_from(f"<{rank}Q", key, 8)
                yield offsets, size, mask, child


def _dense_heap(reader, body, index_size):
    """The fractal heap address of a link info (``index_size`` 8) or
    attribute info (2) message: defined when the links or attributes are
    stored densely."""
    c = reader.cursor(body)
    c.skip(1)
    if c.u8() & 1:
        c.skip(index_size)  # maximum creation index
    return c.offset()


class _Object:
    """An object (group or dataset) of an open file."""

    def __init__(self, reader, address, name, messages=None):
        self._reader = reader
        self._address = address
        self.name = name
        self._messages = messages if messages is not None \
            else reader.messages(address)

    def _find(self, mtype):
        return [body for t, _, body in self._messages if t == mtype]

    @property
    def attrs(self):
        """The attributes as a dict of numpy values, in name order."""
        for body in self._find(_MSG_ATTRIBUTE_INFO):
            if _dense_heap(self._reader, body, 2) != self._reader.undefined:
                raise self._reader.unsupported(
                    f"dense attribute storage (fractal heap) on {self.name}")
        pairs = [self._reader.attribute(body)
                 for body in self._find(_MSG_ATTRIBUTE)]
        return dict(sorted(pairs))


def _open(reader, address, name):
    messages = reader.messages(address)
    types = {t for t, _, _ in messages}
    if _MSG_LAYOUT in types:
        return Dataset(reader, address, name, messages)
    if types & {_MSG_SYMBOL_TABLE, _MSG_LINK, _MSG_LINK_INFO}:
        return Group(reader, address, name, messages)
    raise reader.unsupported(f"object {name} that is neither a group nor "
                             f"a dataset")


class Group(_Object):
    """A group: its links in name order."""

    def _links(self):
        links = {}
        for body in self._find(_MSG_LINK_INFO):
            if _dense_heap(self._reader, body, 8) != self._reader.undefined:
                raise self._reader.unsupported(
                    f"dense link storage (fractal heap) in {self.name}")
        for body in self._find(_MSG_SYMBOL_TABLE):
            links.update(self._reader.symbol_table_links(body))
        for body in self._find(_MSG_LINK):
            name, address = self._reader.link(body)
            links[name] = address
        return dict(sorted(links.items()))

    def _child(self, name, address):
        path = f"{self.name.rstrip('/')}/{name}"
        return _open(self._reader, address, path)

    def __getitem__(self, path):
        node = self if not path.startswith("/") else self._root()
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is not a group")
            links = node._links()
            if part not in links:
                raise KeyError(f"{path} not in {self._reader.path}")
            node = node._child(part, links[part])
        return node

    def _root(self):
        return Group(self._reader, self._reader.root, "/")

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __len__(self):
        return len(self._links())

    def keys(self):
        return list(self._links())

    def items(self):
        return [(name, self._child(name, address))
                for name, address in self._links().items()]


class Dataset(_Object):
    """A dataset: ``[...]`` and ``[()]`` read it whole."""

    def __init__(self, reader, address, name, messages=None):
        super().__init__(reader, address, name, messages)
        [space] = self._find(_MSG_DATASPACE)
        [dtype] = self._find(_MSG_DATATYPE)
        self.shape = reader.dataspace(space)
        self._dtype, self._itemsize = reader.datatype(dtype)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    def __getitem__(self, key):
        data = self._read()
        if isinstance(key, tuple) and key == () and self.shape == ():
            return data[()]
        return data[key]

    def _read(self):
        reader = self._reader
        if self._find(_MSG_EXTERNAL):
            raise reader.unsupported(f"external storage of {self.name}")
        [layout] = self._find(_MSG_LAYOUT)
        c = reader.cursor(layout)
        version, cls = c.u8(), c.u8()
        nbytes = self.size * self._itemsize
        if version not in (3, 4):
            raise reader.unsupported(f"data layout version {version}")
        if cls == 0:
            raw = c.take(c.u16())
        elif cls == 1:
            address, size = c.offset(), c.length()
            if address == reader.undefined:
                raise reader.unsupported(f"{self.name} with no storage "
                                         f"written (its fill value)")
            raw = reader.read(address, nbytes)
        elif cls == 2:
            if version == 4:
                raise reader.unsupported(f"chunk index of data layout v4 "
                                         f"({self.name})")
            raw = self._read_chunked(c)
        elif cls == 3:
            raise reader.unsupported(f"virtual storage of {self.name}")
        else:
            raise reader.unsupported(f"layout class {cls}")
        if len(raw) < nbytes:
            raise ValueError(f"{reader.path}: {self.name} holds "
                             f"{len(raw)} of {nbytes} bytes")
        return reader.decode(raw, self._dtype, self.shape)

    def _filters(self):
        """[(id, flags, client data)] of the filter pipeline."""
        reader = self._reader
        out = []
        for body in self._find(_MSG_FILTERS):
            c = reader.cursor(body)
            version, count = c.u8(), c.u8()
            if version == 1:
                c.skip(6)
            elif version != 2:
                raise reader.unsupported(f"filter pipeline version "
                                         f"{version}")
            for _ in range(count):
                fid = c.u16()
                name_length = c.u16() if version == 1 or fid >= 256 else 0
                flags, n_values = c.u16(), c.u16()
                c.skip(name_length)
                values = [c.u32() for _ in range(n_values)]
                if version == 1 and n_values % 2:
                    c.skip(4)
                if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE,
                               _FILTER_FLETCHER32):
                    name = _FILTER_NAMES.get(fid, f"id {fid}")
                    raise reader.unsupported(f"filter {name} on "
                                             f"{self.name}")
                out.append((fid, flags, values))
        return out

    def _unfilter(self, data, filters, mask):
        for i in reversed(range(len(filters))):
            if mask >> i & 1:
                continue
            fid, _, values = filters[i]
            if fid == _FILTER_DEFLATE:
                data = zlib.decompress(data)
            elif fid == _FILTER_SHUFFLE:
                size = values[0] if values else self._itemsize
                n = len(data) // size
                head = np.frombuffer(data, np.uint8, count=n * size)
                data = head.reshape(size, n).T.tobytes() + data[n * size:]
            else:
                body, stored = data[:-4], int.from_bytes(data[-4:],
                                                         "little")
                want = _fletcher32(body)
                swapped = ((want & 0x00FF00FF) << 8) | (
                    (want >> 8) & 0x00FF00FF)
                if stored not in (want, swapped):
                    raise ValueError(f"{self._reader.path}: fletcher32 "
                                     f"checksum of a chunk of {self.name} "
                                     f"does not match")
                data = body
        return data

    def _read_chunked(self, c):
        reader = self._reader
        ndim = c.u8()
        btree = c.offset()
        dims = [c.u32() for _ in range(ndim)]
        chunk, itemsize = tuple(dims[:-1]), dims[-1]
        rank = len(self.shape)
        if itemsize != self._itemsize or len(chunk) != rank:
            raise ValueError(f"{reader.path}: layout of {self.name} does "
                             f"not match its type and shape")
        filters = self._filters()
        out = np.zeros(self.shape + (itemsize,), np.uint8)
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * itemsize
        covered = 0
        if btree != reader.undefined:
            for offsets, size, mask, address in reader.chunks(btree, rank):
                data = self._unfilter(reader.read(address, size), filters,
                                      mask)
                if len(data) != chunk_bytes:
                    raise ValueError(f"{reader.path}: a chunk of "
                                     f"{self.name} holds {len(data)} bytes,"
                                     f" not {chunk_bytes}")
                block = np.frombuffer(data, np.uint8).reshape(
                    chunk + (itemsize,))
                stop = [min(o + n, d) for o, n, d in
                        zip(offsets, chunk, self.shape)]
                region = tuple(slice(o, s) for o, s in zip(offsets, stop))
                out[region] = block[tuple(slice(0, s - o) for o, s in
                                          zip(offsets, stop))]
                covered += int(np.prod([s - o for o, s in
                                        zip(offsets, stop)]))
        if covered != self.size:
            raise reader.unsupported(f"{self.name} with chunks not written "
                                     f"(its fill value)")
        return out.tobytes()


class File(Group):
    """An HDF5 file opened for reading: the root group."""

    def __init__(self, path, mode="r"):
        if mode != "r":
            raise ValueError("h5read opens files for reading only")
        reader = _Reader(path)
        try:
            super().__init__(reader, reader.root, "/")
        except BaseException:
            reader.fh.close()
            raise

    def close(self):
        self._reader.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
