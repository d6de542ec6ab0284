"""A write-only HDF5 writer in numpy and ``struct``.

The grackle data files are HDF5.  This module writes them on a machine
without h5py or libhdf5, which is the card's machine: it writes the part
of the HDF5 file format (the HDF Group's "HDF5 File Format
Specification", version 3) that h5py writes for such files at its default
``libver="earliest"``, and offers the small part of h5py's surface that
``data/synthetic.py`` calls:

* ``File(path, "w")`` as a context manager;
* ``create_group(path)``, intermediate groups included;
* ``create_dataset(path, data=array)``;
* ``.attrs[key] = value`` on files, groups and datasets;
* ``path in group`` and ``group[path]``.

Written: superblock version 0 with 8-byte offsets and lengths; object
headers v1 (one block each, no continuation); groups as symbol tables (a
v1 B-tree of type 0 over ``SNOD`` nodes and a local heap of names);
dataspace v1, scalar and simple; datatype v1 for IEEE f64 and signed
int64, both little-endian, and for fixed-length NULLPAD ASCII strings
(numpy ``S<n>``); attribute messages v1; data layout v3, contiguous, no
filters.  That is all inside what ``data/h5read.py`` reads.

Anything else raises ``NotImplementedError`` naming the feature -- other
dtypes (float32, float16, complex, bool, unicode ``str``, objects, big
endian), chunks, compression and other dataset options, links,
zero-size data, an attribute too large for a v1 header message, other
open modes -- before anything is written.  The file is assembled in
memory when the ``File`` closes, written to a temporary name in the
target's directory and then renamed over the target, so a reader never
sees half a file.  The same content gives the same bytes: nothing
depends on the clock.

libhdf5 looks names up where ``h5read`` walks every entry, so the group
B-tree is built as libhdf5 searches it: the entries of each ``SNOD`` are
in ``strcmp`` order of their UTF-8 names, key ``i + 1`` of a node is the
heap offset of the largest name under its child ``i``, and key 0 that of
the empty string (of the left sibling's last key, in a node that has
one).  A ``SNOD`` holds at most 2 x (group leaf
node K) = 8 entries and a B-tree node 2 x (group internal node K) = 32
children; a larger group gets several ``SNOD``s, and more than 256
entries a B-tree of more than one level.
"""

from __future__ import annotations

import os
import secrets
import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
#: the superblock's B-tree K values (libhdf5's defaults): a SNOD holds
#: 2 * _LEAF_K entries, a group B-tree node 2 * _INTERNAL_K children
_LEAF_K = 4
_INTERNAL_K = 16
_ENTRY_SIZE = 40  # a symbol table entry: 8 + 8 + 4 + 4 + 16 scratch
_SNOD_SIZE = 8 + 2 * _LEAF_K * _ENTRY_SIZE
_TREE_SIZE = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
#: libhdf5's "no free block" in a local heap's free list (H5HL_FREE_NULL)
_HEAP_FREE_NULL = 1

_MSG_DATASPACE = 0x01
_MSG_DATATYPE = 0x03
_MSG_FILL_VALUE = 0x05
_MSG_LAYOUT = 0x08
_MSG_ATTRIBUTE = 0x0C
_MSG_SYMBOL_TABLE = 0x11
#: the message flag h5py sets on a dataset's datatype and fill value
_FLAG_CONSTANT = 0x01
#: fill value message v2 as h5py writes it: allocation late, fill written
#: if set, a fill value defined, of size 0 (the default, zeros)
_FILL_VALUE = b"\x02\x02\x02\x01\x00\x00\x00\x00"

#: datatype messages: IEEE f64 little-endian (sign bit 63, implied
#: mantissa normalisation, exponent at 52 over 11 bits with bias 1023,
#: mantissa at 0 over 52 bits) and signed int64 little-endian
_F64 = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8, 0, 64, 52, 11,
                   0, 52, 1023)
_I64 = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 8, 0, 64)
_STRING_NULLPAD_ASCII = (0x13, 0x01, 0, 0)


def _pad8(data: bytes) -> bytes:
    return data + b"\0" * (-len(data) % 8)


def _unsupported(feature):
    return NotImplementedError(
        f"{feature} is not supported by grackle_tpu_torch.data.h5write")


def _as_array(value, what):
    """``value`` as a C-ordered numpy array of a supported type, with its
    datatype message; raises NotImplementedError for any other type."""
    if isinstance(value, _Object):
        raise _unsupported(f"{what}: an object as a value (references)")
    arr = np.array(value)  # a copy: later changes to ``value`` are not seen
    if arr.dtype.str == "<f8":
        dtype = _F64
    elif arr.dtype.str == "<i8":
        dtype = _I64
    elif arr.dtype.kind == "S":
        dtype = struct.pack("<BBBBI", *_STRING_NULLPAD_ASCII,
                            arr.dtype.itemsize)
    else:
        raise _unsupported(f"{what}: dtype {arr.dtype.str} ({arr.dtype})")
    if arr.size == 0:
        raise _unsupported(f"{what}: zero-size data")
    return arr, dtype


def _dataspace(shape) -> bytes:
    """Dataspace message v1: scalar, or simple with its maximum dims
    (equal to the dims) as h5py writes them."""
    if not shape:
        return struct.pack("<BBBxI", 1, 0, 0, 0)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBxI", 1, len(shape), 1, 0) + dims + dims


def _message(mtype, body, flags=0) -> bytes:
    body = _pad8(body)
    if len(body) > 0xFFFF:
        raise _unsupported(f"an object header message of {len(body)} "
                           f"bytes (more than a v1 header holds)")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _attribute_message(name, arr, dtype) -> bytes:
    """Attribute message v1: name, datatype and dataspace each padded to
    8 bytes, then the data."""
    raw_name = name.encode("utf-8") + b"\0"
    space = _dataspace(arr.shape)
    body = (struct.pack("<BxHHH", 1, len(raw_name), len(dtype), len(space))
            + _pad8(raw_name) + _pad8(dtype) + _pad8(space) + arr.tobytes())
    return _message(_MSG_ATTRIBUTE, body)


def _check_name(name):
    if not name or "/" in name or "\0" in name or name in (".", ".."):
        raise ValueError(f"{name!r} is not a valid HDF5 link name")


class _Attrs:
    """``.attrs`` of an object being written: values are converted and
    checked when they are set."""

    def __init__(self, owner):
        self._owner = owner
        self._messages = {}

    def __setitem__(self, key, value):
        self._owner._file._check_open()
        if not key or "\0" in key:
            raise ValueError(f"{key!r} is not a valid attribute name")
        arr, dtype = _as_array(value, f"attribute {key!r} of "
                                      f"{self._owner.name}")
        self._messages[key] = _attribute_message(key, arr, dtype)

    def messages(self):
        return list(self._messages.values())


class _Object:
    def __init__(self, file, name):
        self._file = file
        self.name = name
        self.attrs = _Attrs(self)


class Dataset(_Object):
    """A dataset being written: its shape and bytes, copied when it was
    created, and its datatype message."""

    def __init__(self, file, name, arr, dtype_message):
        super().__init__(file, name)
        self.shape = arr.shape
        self._dtype_message = dtype_message
        self._raw = arr.tobytes()


class Group(_Object):
    """A group being written; its members in creation order."""

    def __init__(self, file, name):
        super().__init__(file, name)
        self._members = {}

    def _walk(self, path, create=False):
        """(parent group, last name) of ``path`` relative to this group
        (or to the root when it starts with "/"); the intermediate groups
        are made when ``create`` is set."""
        node = self._file if path.startswith("/") else self
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"{path!r} names no member to create")
        for part in parts[:-1]:
            _check_name(part)
            child = node._members.get(part)
            if child is None:
                if not create:
                    raise KeyError(f"{path} not in {self._file.filename}")
                child = node._add(part, Group)
            if not isinstance(child, Group):
                raise KeyError(f"{child.name} is not a group")
            node = child
        _check_name(parts[-1])
        return node, parts[-1]

    def _add(self, name, cls, *args):
        self._file._check_open()
        if name in self._members:
            raise ValueError(f"Unable to create {name!r} in {self.name} "
                             f"(name already exists)")
        path = f"{self.name.rstrip('/')}/{name}"
        self._members[name] = cls(self._file, path, *args)
        return self._members[name]

    def create_group(self, path):
        parent, name = self._walk(path, create=True)
        return parent._add(name, Group)

    def create_dataset(self, path, data=None, **options):
        """A contiguous dataset holding ``data`` (its shape and dtype).
        Any option (shape, dtype, chunks, compression, fillvalue, ...)
        raises."""
        for key, val in options.items():
            if val is not None and val is not False:
                raise _unsupported(f"create_dataset option {key}={val!r}")
        if data is None:
            raise _unsupported("a dataset without data (its fill value)")
        arr, dtype_message = _as_array(data, f"dataset {path!r}")
        parent, name = self._walk(path, create=True)
        return parent._add(name, Dataset, arr, dtype_message)

    def __getitem__(self, path):
        if not path.strip("/"):
            return self._file if path.startswith("/") else self
        parent, name = self._walk(path)
        if name not in parent._members:
            raise KeyError(f"{path} not in {self._file.filename}")
        return parent._members[name]

    def __setitem__(self, path, value):
        raise _unsupported(f"assigning {path!r} (links; use "
                           f"create_dataset)")

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True


class File(Group):
    """An HDF5 file opened for writing (mode "w": created or truncated
    when it closes): the root group."""

    def __init__(self, path, mode="w"):
        if mode != "w":
            raise _unsupported(f"mode {mode!r} (h5write only creates "
                               f"files, mode 'w')")
        self.filename = os.fspath(path)
        self._open = True
        super().__init__(self, "/")

    def _check_open(self):
        if not self._open:
            raise ValueError(f"{self.filename} is closed")

    def close(self):
        """Write the file (to a temporary name, then renamed over the
        target) and close it; a second close does nothing."""
        if not self._open:
            return
        self._open = False
        data = _Layout(self).tobytes()
        target = os.path.abspath(self.filename)
        tmp = os.path.join(os.path.dirname(target),
                           f".{os.path.basename(target)}."
                           f"{secrets.token_hex(6)}.tmp")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
            os.replace(tmp, target)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # write nothing of a file whose content failed
            self._open = False


class _Layout:
    """The file's bytes: every block 8-byte aligned and placed in the
    order it is first needed, each object header before its members."""

    def __init__(self, root):
        self.buf = bytearray(96)  # superblock v0 with the root's entry
        header, btree, heap = self.group(root)
        root_entry = self.entry(0, header, (btree, heap))
        self.buf[:96] = (
            _SIGNATURE
            + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                          _INTERNAL_K, 0)
            + struct.pack("<QQQQ", 0, _UNDEFINED, len(self.buf),
                          _UNDEFINED)
            + root_entry)

    def tobytes(self):
        return bytes(self.buf)

    def alloc(self, size):
        self.buf.extend(b"\0" * (-len(self.buf) % 8))
        address = len(self.buf)
        self.buf.extend(b"\0" * size)
        return address

    def put(self, address, data):
        self.buf[address:address + len(data)] = data

    def header(self, messages):
        """Reserve an object header v1 of ``messages`` (their sizes are
        known before their addresses are); returns (address, fill) where
        ``fill(messages)`` writes it."""
        size = sum(len(m) for m in messages)
        address = self.alloc(16 + size)

        def fill(final):
            body = b"".join(final)
            assert len(body) == size
            self.put(address, struct.pack("<BxHII4x", 1, len(final), 1,
                                          size) + body)
        return address, fill

    @staticmethod
    def entry(name_offset, header, stab=None):
        """A symbol table entry; a group's entry caches its B-tree and
        heap addresses (cache type 1), as libhdf5 writes it."""
        if stab is None:
            return struct.pack("<QQI4x16x", name_offset, header, 0)
        return struct.pack("<QQI4xQQ", name_offset, header, 1, *stab)

    def dataset(self, dset):
        space = _message(_MSG_DATASPACE, _dataspace(dset.shape))
        dtype = _message(_MSG_DATATYPE, dset._dtype_message, _FLAG_CONSTANT)
        fill = _message(_MSG_FILL_VALUE, _FILL_VALUE, _FLAG_CONSTANT)
        attrs = dset.attrs.messages()
        layout_size = len(_message(_MSG_LAYOUT, bytes(18)))
        address, write = self.header([space, dtype, fill, b"\0" *
                                      layout_size] + attrs)
        data = self.alloc(len(dset._raw))
        self.put(data, dset._raw)
        layout = _message(_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data,
                                                   len(dset._raw)))
        write([space, dtype, fill, layout] + attrs)
        return address

    def group(self, group):
        """Write ``group`` and everything under it; returns its header,
        B-tree and heap addresses."""
        attrs = group.attrs.messages()
        stab_size = len(_message(_MSG_SYMBOL_TABLE, bytes(16)))
        address, write = self.header([b"\0" * stab_size] + attrs)

        names = sorted(group._members, key=lambda n: n.encode("utf-8"))
        heap_data = bytearray(8)  # offset 0: the empty string
        offsets = {}
        for name in names:
            offsets[name] = len(heap_data)
            heap_data += _pad8(name.encode("utf-8") + b"\0")
        entries = []
        for name in names:
            member = group._members[name]
            if isinstance(member, Group):
                header, btree, heap = self.group(member)
                entries.append(self.entry(offsets[name], header,
                                          (btree, heap)))
            else:
                entries.append(self.entry(offsets[name],
                                          self.dataset(member)))

        heap = self.alloc(32 + len(heap_data))
        self.put(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                             _HEAP_FREE_NULL, heap + 32)
                 + heap_data)
        # the leaves: SNODs of at most 2 * _LEAF_K entries, each with the
        # heap offset of its largest name
        per_snod = 2 * _LEAF_K
        level = []
        for start in range(0, len(names), per_snod):
            chunk = entries[start:start + per_snod]
            snod = self.alloc(_SNOD_SIZE)
            self.put(snod, b"SNOD" + struct.pack("<BxH", 1, len(chunk))
                     + b"".join(chunk))
            level.append((snod, offsets[names[start + len(chunk) - 1]]))
        btree = self.btree(level)
        write([_message(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]
              + attrs)
        return address, btree, heap

    def btree(self, children):
        """The group B-tree over ``children`` ((address, offset of the
        largest name under it)), built bottom up at most 2 * _INTERNAL_K
        children a node, siblings linked; returns the root's address.
        A node's key 0 is its left sibling's last key (0, the empty
        name, for the first node of a level)."""
        fan = 2 * _INTERNAL_K
        depth = 0
        while True:
            groups = [children[i:i + fan]
                      for i in range(0, len(children), fan)] or [[]]
            nodes = [self.alloc(_TREE_SIZE) for _ in groups]
            for i, (node, kids) in enumerate(zip(nodes, groups)):
                left = nodes[i - 1] if i else _UNDEFINED
                right = nodes[i + 1] if i + 1 < len(nodes) else _UNDEFINED
                body = struct.pack("<Q", groups[i - 1][-1][1] if i else 0)
                for child, largest in kids:
                    body += struct.pack("<QQ", child, largest)
                self.put(node, b"TREE" + struct.pack(
                    "<BBHQQ", 0, depth, len(kids), left, right) + body)
            if len(nodes) == 1:
                return nodes[0]
            children = [(node, kids[-1][1])
                        for node, kids in zip(nodes, groups)]
            depth += 1
