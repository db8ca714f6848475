"""HDF5 reader and writer for the port's data files, in numpy and the
standard library alone.

The card's machine has no `h5py`, and the port's h5 files (the
preprocessed dataset of `data/preprocess.py`, the region codes of
`cli/extract_features.py`) are a small, fixed subset of HDF5: the one
`h5py` writes with its defaults. This module reads and writes that
subset, under the names of the `h5py` calls the port makes:

    with h5.File(path, "w") as f:
        d = f.create_dataset("images", (n, 3, S, S), dtype=np.uint8)
        d[i] = canvas
        f.create_dataset("paths", data=np.asarray(paths,
                                                  dtype=h5.string_dtype()))
    with h5.File(path) as f:
        f.keys(), "images" in f, f["images"].shape, f["images"][i]

What it reads (anything else raises ValueError naming what it found):

  superblock   version 0 at offset 0, 8-byte offsets and lengths
  objects      object headers version 1 (messages 8-byte aligned),
               continuation blocks followed
  the root     a symbol-table group: the v1 B-tree of group nodes (any
  group        number of SNOD leaves) and the local heap of names; its
               members are datasets
  dataspaces   versions 1 and 2, scalar or simple
  datatypes    little-endian fixed-point (signed and unsigned, 1, 2, 4,
               8 bytes) and IEEE float (4, 8 bytes); h5py's bool, an
               enum over int8 of FALSE = 0 and TRUE = 1, read as
               np.bool_; variable-length UTF-8 strings, read from global
               heap collections as `bytes`, as h5py gives them
  layouts      data layout message version 3, contiguous. Chunked and
               compact layouts, filters (gzip, shuffle, ...) and external
               files are refused
  fill values  fill value message versions 1 and 2: a dataset with no
               storage (never written, or of size 0) reads as its fill
               value, or zeros

Reads are lazy: a contiguous dataset is read by index (`d[i]`,
`d[a:b]`, `d[:]`, `d[()]`) with one `os.preadv` at its offset into the
array returned, never loaded whole, and `os.preadv` takes no shared
file position, so threads (the prefetching loader's, a second handle's)
read one file at once. `close` waits for the reads in flight, so a
descriptor number that a later open reuses is never read under them.

The writer writes the same layout, so one reader serves both: every
dataset contiguous, its data region allocated when it is created (every
shape is known then), written by index as it comes (`d[i] = row`) and
never moved; at `close` the object headers, the names' local heap, the
group's SNOD leaves and B-tree node and the superblock go in. Bool is
written as h5py's enum, strings of `string_dtype()` as variable-length
UTF-8 in global heap collections. `h5py` reads the files with the same
names, dtypes, shapes and values.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 2 ** 64 - 1  # the undefined address

# object header message types
MSG_DATASPACE = 0x01
MSG_DATATYPE = 0x03
MSG_FILL = 0x05
MSG_EXTERNAL = 0x07
MSG_LAYOUT = 0x08
MSG_FILTERS = 0x0B
MSG_CONTINUATION = 0x10
MSG_SYMBOL_TABLE = 0x11

# datatype classes
CLASS_FIXED, CLASS_FLOAT, CLASS_ENUM, CLASS_VLEN = 0, 1, 8, 9

# what the writer writes (h5py's defaults, HDF5's "earliest" format)
GROUP_LEAF_K = 4        # an SNOD holds 2K = 8 names
GROUP_INTERNAL_K = 16   # a B-tree node has up to 2K = 32 children
SUPERBLOCK_SIZE = 96
SNOD_SIZE = 8 + 2 * GROUP_LEAF_K * 40  # 40: one symbol table entry
BTREE_SIZE = 24 + 2 * GROUP_INTERNAL_K * 8 + (2 * GROUP_INTERNAL_K + 1) * 8
MAX_NAMES = 2 * GROUP_INTERNAL_K * 2 * GROUP_LEAF_K  # one B-tree node
HEAP_MIN = 4096         # the least size of a global heap collection
HEAP_OBJECTS = 65535    # object indices are 16 bits (0 is free space)

# the 16-byte element of a variable-length string dataset
VLEN_RECORD = np.dtype([("len", "<u4"), ("collection", "<u8"),
                        ("index", "<u4")])
# (precision, exponent location, exponent size, mantissa size, bias)
IEEE = {4: (32, 23, 8, 23, 127), 8: (64, 52, 11, 52, 1023)}


def string_dtype():
    """h5py.string_dtype(): variable-length UTF-8 strings."""
    return np.dtype("O", metadata={"vlen": str})


def _is_vlen(dtype):
    return dtype.kind == "O" and (dtype.metadata or {}).get("vlen") is str


def _align8(n):
    return (n + 7) & ~7


def _u64(buf, pos=0):
    return struct.unpack_from("<Q", buf, pos)[0]


class File:
    """h5py.File's counterpart for the root group's datasets: mode "r"
    reads an existing file, "w" creates one (truncating). `keys()`,
    iteration, `in`, `len`, `f[name]` (a Dataset) and, for "w",
    `create_dataset`. A context manager; `close` is where the writer
    writes the metadata."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: the codec opens files with "
                             "'r' or 'w'")
        self.path = os.fspath(path)
        self.writable = mode == "w"
        # guards the caches below and `_users`, the reads and writes in
        # flight; `close` waits on `_idle` until there are none
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)
        self._users = 0
        self._heaps = {}  # global heap collection address -> {index: bytes}
        # name -> its object header's address, or its Dataset once read
        self._links = {}
        if self.writable:
            self._fd = os.open(self.path,
                               os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
            self._eof = SUPERBLOCK_SIZE
            return
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._links = self._root_links()
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Close the file once no read or write is in flight; the writer
        first writes the metadata. Reads that start after it raise."""
        with self._idle:  # an RLock: _finish's own writes re-enter it
            while self._users:
                self._idle.wait()
            if self._fd is None:
                return
            try:
                if self.writable:
                    self._finish()
            finally:
                os.close(self._fd)
                self._fd = None

    def keys(self):
        return sorted(self._links)

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, name):
        return name in self._links

    def __len__(self):
        return len(self._links)

    def __getitem__(self, name):
        """The dataset `name` (its header is read at the first access)."""
        obj = self._links[name]
        if isinstance(obj, Dataset):
            return obj
        with self._lock:
            if not isinstance(self._links[name], Dataset):
                self._links[name] = Dataset._read(self, name,
                                                  self._messages(obj))
        return self._links[name]

    # -- raw I/O ---------------------------------------------------------
    @contextlib.contextmanager
    def _open_fd(self):
        """The descriptor, which `close` leaves open until the block
        ends."""
        with self._lock:
            if self._fd is None:
                raise ValueError(f"{self.path}: the file is closed")
            self._users += 1
        try:
            yield self._fd
        finally:
            with self._lock:
                self._users -= 1
                if not self._users:
                    self._idle.notify_all()

    def _pread(self, addr, n):
        with self._open_fd() as fd:
            b = os.pread(fd, n, addr)
        if len(b) != n:
            raise ValueError(f"{self.path}: truncated: {n} bytes wanted at "
                             f"{addr}, {len(b)} there")
        return b

    def _read_into(self, arr, addr):
        """Fill the C-contiguous array `arr` from the file at `addr`."""
        view, done = memoryview(arr.reshape(-1).view(np.uint8)), 0
        with self._open_fd() as fd:
            while done < len(view):
                n = os.preadv(fd, [view[done:]], addr + done)
                if n <= 0:
                    raise ValueError(f"{self.path}: truncated at "
                                     f"{addr + done}")
                done += n

    def _pwrite(self, data, addr):
        """Write bytes, or a C-contiguous array, at `addr`."""
        if isinstance(data, np.ndarray):
            data = data.reshape(-1).view(np.uint8)
        view, done = memoryview(data), 0
        with self._open_fd() as fd:
            while done < len(view):
                done += os.pwrite(fd, view[done:], addr + done)

    # -- reading the metadata --------------------------------------------
    def _root_links(self):
        """{name: object header address} of the root group, from the
        superblock, the root's symbol table, its local heap of names, and
        the B-tree's SNOD leaves."""
        sb = self._pread(0, SUPERBLOCK_SIZE)
        if sb[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at offset 0")
        if sb[8] != 0:
            raise ValueError(f"{self.path}: superblock version {sb[8]}; "
                             "the codec reads version 0 (h5py's default)")
        if sb[13] != 8 or sb[14] != 8:
            raise ValueError(f"{self.path}: offsets of {sb[13]} bytes and "
                             f"lengths of {sb[14]}; the codec reads 8 and 8")
        if _u64(sb, 24):
            raise ValueError(f"{self.path}: base address {_u64(sb, 24)} (a "
                             "user block); the codec reads base address 0")
        for mtype, _, body in self._messages(_u64(sb, 64)):
            if mtype == MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", body)
                break
        else:
            raise ValueError(f"{self.path}: the root group has no symbol "
                             "table (a group of the newer format)")
        head = self._pread(heap, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        names = self._pread(data_addr, size)
        links, todo = {}, [btree]
        while todo:
            node = todo.pop()
            head = self._pread(node, 24)
            if head[:5] != b"TREE\0":
                raise ValueError(f"{self.path}: no group B-tree node at "
                                 f"{node}")
            level, used = head[5], struct.unpack_from("<H", head, 6)[0]
            # keys and children interleave: key0, child0, key1, child1, ...
            body = self._pread(node + 24, used * 16)
            children = [_u64(body, 16 * i + 8) for i in range(used)]
            if level:
                todo.extend(reversed(children))
                continue
            for snod in children:
                head = self._pread(snod, 8)
                if head[:4] != b"SNOD":
                    raise ValueError(f"{self.path}: no symbol table node "
                                     f"at {snod}")
                count = struct.unpack_from("<H", head, 6)[0]
                entries = self._pread(snod + 8, 40 * count)
                for i in range(count):
                    off, header = struct.unpack_from("<QQ", entries, 40 * i)
                    name = names[off:names.index(b"\0", off)].decode()
                    links[name] = header
        return links

    def _messages(self, addr):
        """[(type, flags, body)] of the version-1 object header at addr,
        continuation blocks followed."""
        version, _, _, _, size = struct.unpack_from(
            "<BBHII", self._pread(addr, 16))
        if version != 1:
            raise ValueError(f"{self.path}: object header version {version} "
                             f"at {addr}; the codec reads version 1")
        blocks, out = [(addr + 16, size)], []
        while blocks:
            start, n = blocks.pop(0)
            buf = self._pread(start, n)
            pos = 0
            while pos + 8 <= n:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                body = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x02:
                    raise ValueError(f"{self.path}: a shared message (type "
                                     f"{mtype:#x}) at {addr}")
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, flags, body))
        return out

    def _heap_object(self, collection, index):
        """Object `index` of the global heap collection at `collection`."""
        objs = self._heaps.get(collection)
        if objs is None:
            head = self._pread(collection, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"{self.path}: no global heap at "
                                 f"{collection}")
            size = _u64(head, 8)
            buf = self._pread(collection, size)
            objs, pos = {}, 16
            while pos + 16 <= size:
                idx, _, _, n = struct.unpack_from("<HHIQ", buf, pos)
                if idx == 0:  # free space: the rest of the collection
                    break
                objs[idx] = buf[pos + 16:pos + 16 + n]
                pos += 16 + _align8(n)
            with self._lock:
                self._heaps[collection] = objs
        try:
            return objs[index]
        except KeyError:
            raise ValueError(f"{self.path}: no object {index} in the global "
                             f"heap at {collection}") from None

    # -- writing ---------------------------------------------------------
    def create_dataset(self, name, shape=None, dtype=None, data=None):
        """A contiguous dataset of `shape` and `dtype` (float32 by
        default, as h5py's), its region allocated now; `data`, from which
        shape and dtype follow, is written at once. -> the Dataset,
        writable by index."""
        if not self.writable:
            raise ValueError(f"{self.path} is open for reading")
        if not name or "/" in name or name in self._links:
            raise ValueError(f"dataset name {name!r}: empty, nested or "
                             "already there")
        if len(self._links) == MAX_NAMES:
            raise ValueError(f"the codec writes at most {MAX_NAMES} datasets")
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            if shape is not None and tuple(shape) != data.shape:
                raise ValueError(f"shape {tuple(shape)} != the data's "
                                 f"{data.shape}")
            shape, dtype = data.shape, data.dtype
        elif shape is None:
            raise ValueError("create_dataset needs a shape or data")
        shape = (shape,) if isinstance(shape, int) else tuple(
            int(n) for n in shape)
        dtype = np.dtype(np.float32 if dtype is None else dtype)
        if not _is_vlen(dtype):
            dtype = dtype.newbyteorder("<")
        _encode_dtype(dtype)  # refuses what the codec cannot write
        ds = Dataset(self, name, shape, dtype)
        nbytes = ds.size * ds._stored.itemsize
        if nbytes:
            ds._addr = self._allocate(nbytes)
        self._links[name] = ds
        if data is not None and data.size:
            ds[...] = data
        return ds

    def _allocate(self, nbytes):
        """Room for nbytes at the end; the file grows to hold it (sparse:
        a region never written reads as zeros, the fill value)."""
        addr = _align8(self._eof)
        self._eof = addr + nbytes
        with self._open_fd() as fd:
            os.ftruncate(fd, self._eof)
        return addr

    def _append(self, block):
        addr = self._allocate(len(block))
        self._pwrite(block, addr)
        return addr

    def _write_strings(self, values):
        """Encoded strings -> their VLEN_RECORD elements, the strings
        written to new global heap collections."""
        out = np.zeros(len(values), VLEN_RECORD)
        for start in range(0, len(values), HEAP_OBJECTS):
            chunk = values[start:start + HEAP_OBJECTS]
            body = bytearray()
            for i, s in enumerate(chunk, start=1):
                body += struct.pack("<HHIQ", i, 0, 0, len(s))
                body += s + bytes(_align8(len(s)) - len(s))
            size = max(HEAP_MIN, 16 + len(body))
            free = size - 16 - len(body)
            if free >= 16:  # a smaller tail is free space without a header
                body += struct.pack("<HHIQ", 0, 0, 0, free)
            block = b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body
            addr = self._append(block + bytes(size - len(block)))
            n = len(chunk)
            out["len"][start:start + n] = [len(s) for s in chunk]
            out["collection"][start:start + n] = addr
            out["index"][start:start + n] = np.arange(1, n + 1)
        return out

    def _finish(self):
        """Write every dataset's object header, the root group's names,
        SNOD leaves and B-tree node, its header and the superblock."""
        names = sorted(self._links, key=str.encode)
        headers = {n: self._append(self._links[n]._header()) for n in names}
        # the local heap of link names; offset 0 is the empty name
        heap_data, offsets = bytearray(8), {}
        for n in names:
            offsets[n] = len(heap_data)
            raw = n.encode() + b"\0"
            heap_data += raw + bytes(_align8(len(raw)) - len(raw))
        heap = self._allocate(32 + len(heap_data))
        # no free block: HDF5's H5HL_FREE_NULL (1)
        self._pwrite(b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap_data), 1, heap + 32) + heap_data, heap)
        # leaves of at most 2K names, each keyed by its last name
        btree = b"TREE" + struct.pack(
            "<BBHQQQ", 0, 0, -(-len(names) // (2 * GROUP_LEAF_K)), UNDEF,
            UNDEF, 0)
        for i in range(0, len(names), 2 * GROUP_LEAF_K):
            leaf = names[i:i + 2 * GROUP_LEAF_K]
            block = b"SNOD\x01\0" + struct.pack("<H", len(leaf)) + b"".join(
                struct.pack("<QQ24x", offsets[n], headers[n]) for n in leaf)
            btree += struct.pack("<QQ", self._append(block.ljust(
                SNOD_SIZE, b"\0")), offsets[leaf[-1]])
        btree = self._append(btree.ljust(BTREE_SIZE, b"\0"))
        root = self._append(_object_header(
            [(MSG_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))]))
        eof = _align8(self._eof)
        self._pwrite(
            SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
            # the root's symbol table entry, its B-tree and heap cached
            + struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap), 0)
        os.ftruncate(self._fd, eof)


def _object_header(messages):
    """A version-1 object header of [(type, flags, body)] messages."""
    body = bytearray()
    for mtype, flags, data in messages:
        size = _align8(len(data))
        body += struct.pack("<HHB3x", mtype, size, flags)
        body += data + bytes(size - len(data))
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _parse_dtype(body, where):
    """A datatype message body -> (numpy dtype as read, bytes used)."""
    cls = body[0] & 0x0F
    bits = int.from_bytes(body[1:4], "little")
    size = int.from_bytes(body[4:8], "little")
    if cls in (CLASS_FIXED, CLASS_FLOAT) and bits & 0x41:
        raise ValueError(f"{where}: big-endian (or VAX) data")
    if cls == CLASS_FIXED:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"{where}: an integer of {size} bytes with "
                             f"{precision} bits at offset {offset}")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}"), 12
    if cls == CLASS_FLOAT:
        offset, *layout = struct.unpack_from("<HHBBBBI", body, 8)
        precision, eloc, esize, mloc, msize, bias = layout
        if (offset or mloc or size not in IEEE
                or (precision, eloc, esize, msize, bias) != IEEE[size]):
            raise ValueError(f"{where}: a float of {size} bytes that is not "
                             "IEEE single or double")
        return np.dtype(f"<f{size}"), 20
    if cls == CLASS_ENUM:  # names null-terminated, padded to 8 bytes
        base, used = _parse_dtype(body[8:], where)
        pos, members = 8 + used, []
        for _ in range(bits & 0xFFFF):
            end = body.index(b"\0", pos)
            members.append(body[pos:end])
            pos += _align8(end + 1 - pos)
        values = np.frombuffer(body, base, len(members), pos)
        if base != np.int8 or dict(zip(members, values.tolist())) != {
                b"FALSE": 0, b"TRUE": 1}:
            raise ValueError(f"{where}: an enum other than h5py's bool")
        return np.dtype(np.bool_), pos + values.nbytes
    if cls == CLASS_VLEN:
        if (bits & 0x0F) != 1 or (bits >> 8) & 0x0F != 1:
            raise ValueError(f"{where}: a variable-length type other than "
                             "UTF-8 strings")
        _, used = _parse_dtype(body[8:], where)
        return string_dtype(), 8 + used
    raise ValueError(f"{where}: datatype class {cls}")


def _encode_dtype(dtype):
    """The datatype message body of a numpy dtype the writer takes."""
    if _is_vlen(dtype):  # over unsigned char; UTF-8, null-terminated
        return bytes([0x19, 0x01, 0x01, 0]) + struct.pack(
            "<I", 16) + _encode_dtype(np.dtype(np.uint8))
    if dtype == np.bool_:
        return (bytes([0x18, 2, 0, 0]) + struct.pack("<I", 1)
                + _encode_dtype(np.dtype(np.int8))
                + b"FALSE\0\0\0TRUE\0\0\0\0" + bytes([0, 1]))
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0]) + \
            struct.pack("<IHH", size, 0, 8 * size)
    if dtype.kind == "f" and size in IEEE:
        precision, eloc, esize, msize, bias = IEEE[size]
        return bytes([0x11, 0x20, precision - 1, 0]) + struct.pack(
            "<IHHBBBBI", size, 0, precision, eloc, esize, 0, msize, bias)
    raise ValueError(f"dtype {dtype}: the codec writes integers, float32, "
                     "float64, bool and string_dtype()")


class Dataset:
    """One dataset: `.shape`, `.dtype`, `.size`, and reads of whole rows
    of the first axis: `d[i]`, `d[a:b]` (step 1), `d[:]`, and `d[()]` or
    `d[...]` for all. A dataset of a file open for writing is also
    written so, with a value of the rows' shape."""

    def __init__(self, file, name, shape, dtype):
        self._file, self.name = file, name
        self.shape, self.dtype = shape, dtype
        self.size = int(np.prod(shape, dtype=np.int64))
        # the elements as they lie in the file
        self._stored = (VLEN_RECORD if _is_vlen(dtype) else np.dtype(np.int8)
                        if dtype == np.bool_ else dtype)
        self._addr = None  # None: no storage; it reads as the fill value
        self._fill = None

    @classmethod
    def _read(cls, file, name, msgs):
        where = f"{file.path}:{name}"
        found = {mtype: body for mtype, _, body in msgs}
        for mtype, what in ((MSG_FILTERS, "filtered (e.g. gzip)"),
                            (MSG_EXTERNAL, "externally stored")):
            if mtype in found:
                raise ValueError(f"{where}: a {what} dataset")
        if not {MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT} <= found.keys():
            raise ValueError(f"{where}: not a dataset (a group?)")
        space = found[MSG_DATASPACE]
        version, rank = space[0], space[1]
        if version not in (1, 2) or (version == 2 and space[3] == 2):
            raise ValueError(f"{where}: dataspace version {version}, or a "
                             "null dataspace")
        shape = struct.unpack_from(f"<{rank}Q", space,
                                   8 if version == 1 else 4)
        ds = cls(file, name, shape, _parse_dtype(found[MSG_DATATYPE],
                                                 where)[0])
        layout = found[MSG_LAYOUT]
        if layout[0] != 3 or layout[1] != 1:
            kind = {0: "compact", 2: "chunked"}.get(layout[1], layout[1])
            raise ValueError(f"{where}: data layout version {layout[0]}, "
                             f"{kind}; the codec reads version 3, "
                             "contiguous")
        addr, size = struct.unpack_from("<QQ", layout, 2)
        if addr != UNDEF:
            if size < ds.size * ds._stored.itemsize:
                raise ValueError(f"{where}: {size} bytes of storage for "
                                 f"{ds.size} elements")
            ds._addr = addr
        elif MSG_FILL in found:
            ds._fill = _fill_value(found[MSG_FILL], ds._stored.itemsize,
                                   where)
        return ds

    # -- reading -----------------------------------------------------------
    def _rows(self, key):
        """An index -> the rows [r0, r1) of the first axis, and whether
        that axis goes (an int)."""
        n = self.shape[0] if self.shape else 1
        if key is Ellipsis or (isinstance(key, tuple) and not key):
            return 0, n, False
        if self.shape and isinstance(key, (int, np.integer)) and \
                not isinstance(key, (bool, np.bool_)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {key} out of range for {n} rows")
            return i, i + 1, True
        if self.shape and isinstance(key, slice) and key.step in (None, 1):
            start, stop, _ = key.indices(n)
            return start, max(start, stop), False
        raise ValueError(f"{self.name}[{key!r}]: the codec indexes whole "
                         "rows: d[i], d[a:b], d[:], d[()] or d[...]")

    def _read_rows(self, r0, r1):
        """Rows [r0, r1) of the first axis as stored."""
        shape = ((r1 - r0,) + self.shape[1:]) if self.shape else ()
        if self._addr is None:
            out = np.zeros(shape, self._stored)
            if self._fill is not None:
                out[...] = np.frombuffer(self._fill, self._stored, 1)[0]
            return out
        out = np.empty(shape, self._stored)
        if out.size:
            row = out.nbytes // (r1 - r0) if self.shape else 0
            self._file._read_into(out, self._addr + r0 * row)
        return out

    def _decode(self, stored):
        if self._stored == VLEN_RECORD:
            out = np.empty(stored.shape, object)
            flat = out.reshape(-1)
            for i, (n, coll, idx) in enumerate(stored.reshape(-1).tolist()):
                flat[i] = self._file._heap_object(coll, idx)[:n] if n \
                    else b""
            return out
        if self.dtype == np.bool_:
            return stored.view(np.bool_)
        return stored

    def __getitem__(self, key):
        r0, r1, drop = self._rows(key)
        arr = self._decode(self._read_rows(r0, r1))
        return arr[0] if drop else arr[()]  # a scalar's [()]: numpy's

    # -- writing -----------------------------------------------------------
    def _encode(self, values):
        if self._stored == VLEN_RECORD:
            flat = [v.encode() if isinstance(v, str) else bytes(v)
                    for v in values.reshape(-1).tolist()]
            return self._file._write_strings(flat).reshape(values.shape)
        return np.ascontiguousarray(values, self.dtype).view(self._stored)

    def __setitem__(self, key, value):
        if not self._file.writable:
            raise ValueError(f"{self._file.path} is open for reading")
        r0, r1, drop = self._rows(key)
        value = np.asarray(value, object if self._stored == VLEN_RECORD
                           else self.dtype)
        target = (self.shape[1:] if drop else (r1 - r0,) + self.shape[1:]
                  if self.shape else ())
        if value.shape != target:
            raise ValueError(f"{self.name}[{key!r}]: a value of shape "
                             f"{value.shape} for rows of {target}")
        if self._addr is None:  # size 0: nothing to write
            return
        stored = self._encode(value)
        row = self._stored.itemsize * int(np.prod(self.shape[1:],
                                                  dtype=np.int64))
        self._file._pwrite(np.ascontiguousarray(stored),
                           self._addr + r0 * row)

    def _header(self):
        """This dataset's object header (the writer's, at close)."""
        rank = len(self.shape)
        space = bytes([1, rank, 1 if rank else 0, 0, 0, 0, 0, 0]) + \
            struct.pack(f"<{2 * rank}Q", *self.shape, *self.shape)
        # version 2: allocated late, written if set (on allocation for
        # strings), the library's default value: h5py's own message
        vlen = self._stored == VLEN_RECORD
        fill = bytes([2, 2, 0 if vlen else 2, 1]) + struct.pack("<I", 0)
        layout = bytes([3, 1]) + struct.pack(
            "<QQ", UNDEF if self._addr is None else self._addr,
            self.size * self._stored.itemsize)
        return _object_header([(MSG_DATASPACE, 0, space),
                               (MSG_DATATYPE, 1, _encode_dtype(self.dtype)),
                               (MSG_FILL, 1, fill), (MSG_LAYOUT, 0, layout)])


def _fill_value(body, itemsize, where):
    """The fill value's bytes from a fill value message (versions 1 and
    2), or None for the default (zeros)."""
    if body[0] not in (1, 2):
        raise ValueError(f"{where}: fill value message version {body[0]}")
    if body[0] == 2 and not body[3]:  # not defined
        return None
    size = struct.unpack_from("<I", body, 4)[0]
    if size and size != itemsize:
        raise ValueError(f"{where}: a fill value of {size} bytes")
    return body[8:8 + size] if size else None
