"""The port's own HDF5 reader and writer for dotTHz files.

Built on numpy, ``zlib`` and the standard library only, so that opening,
saving and updating a scan needs no HDF5 library. The surface is the part
of h5py's that the port uses: :class:`File` as a context manager; groups
with ``keys()`` (ascending byte order of the names, as h5py lists them),
``[name]``, ``in`` and ``attrs``; datasets with ``shape``, ``ndim``,
``dtype``, ``[()]`` and basic slices; :func:`is_group` /
:func:`is_dataset` in place of ``isinstance(obj, h5py.Group)``.

Reading covers what h5py writes for the dotTHz layout with either
``libver``:

* superblocks v0-v3; object headers v1 (8-byte-aligned messages,
  continuation blocks) and v2 (``OHDR``/``OCHK``, lookup3 checksums);
* symbol-table groups (v1 B-tree of any depth, ``SNOD``, local heap) and
  link-message groups, compact or dense (fractal heap + v2 B-tree);
* compact and dense attributes: a fractal heap with direct and indirect
  blocks (checksummed direct blocks too) and a v2 B-tree of any depth;
* fixed- and floating-point types of either byte order, fixed-length
  strings, variable-length strings in a global heap (``GCOL``);
* scalar and simple dataspaces;
* compact, contiguous and chunked layouts, the chunks indexed by a v1
  B-tree, a fixed array (paged or not) or a single-chunk index;
* the deflate, shuffle and fletcher32 filters, the checksum checked.

A contiguous dataset is read through ``np.memmap`` at its offset, so a
slice reads only its bytes; a chunked one decodes only the chunks that a
slice touches and crops the edge chunks. Anything else raises
:class:`UnsupportedFeature` naming the HDF5 feature (other filters, the
extensible-array and v2-B-tree chunk indices, external storage, compound,
enum, reference and variable-length sequence types, committed datatypes,
huge heap objects), and a damaged file raises :class:`HDF5Error` (a bad
signature or checksum, a truncated structure), never a wrong array.

Writing (mode ``"w"``) makes what the port's callers create: superblock
v0, symbol-table groups, contiguous datasets (integer and IEEE float
types of either byte order) and attributes, a ``str`` as a
variable-length UTF-8 string as h5py stores one, numbers as numeric
scalars or arrays, ``np.bytes_`` as a fixed-length string. h5py reads the
result; the default format was chosen because every HDF5 library since
1.8 reads it and it needs no metadata checksums.

Mode ``"r+"`` changes attributes, which is what ``update_metadata`` does.
It never rewrites the file, in either format: a 512×512×1024 cube is
1 GiB and its bytes stay where they are. At close each changed group gets
a new object header appended at the end of the file (its non-attribute
messages copied, every attribute compact, new strings in a new global
heap collection; a v2 header is written as v2 with its checksum, its
attribute-info message reset to compact storage). Then the one address
that names the group in its parent is repointed: a symbol-table entry, a
compact link message (its header chunk's checksum recomputed) or a dense
link in a fractal-heap block (that block's checksum recomputed). Last the
superblock's end-of-file address moves (its checksum too for v2/v3). The
old header and heap objects stay as unreferenced bytes. The appended
bytes are flushed before the repointing write, so a crash before it
leaves the old metadata in place.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_M32 = 0xFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x07, 0x08, 0x0A, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x10, 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "n-bit",
                 6: "scale-offset", 32000: "lzf"}
_TYPE_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                     8: "enum", 10: "array"}
# (precision, exponent location, exponent size, mantissa size) of IEEE types
_IEEE = {2: (16, 10, 5, 10), 4: (32, 23, 8, 23), 8: (64, 52, 11, 52)}


class HDF5Error(ValueError):
    """A file that is not HDF5, or is damaged or truncated."""


class UnsupportedFeature(HDF5Error):
    """An HDF5 feature this module does not read or write."""

    def __init__(self, feature: str):
        super().__init__(f"unsupported HDF5 feature: {feature}")


# -- checksums --------------------------------------------------------------

def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``: HDF5's metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    data = bytes(data)
    i = 0
    while n - i > 12:
        x, y, z = struct.unpack_from("<3I", data, i)
        a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
        i += 12
    x, y, z = struct.unpack("<3I", data[i:] + bytes(12 - (n - i)))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def fletcher32(data) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words, sums folded every 360 words, an odd last byte as a high byte."""
    data = bytes(data)
    n_words = len(data) // 2
    words = np.frombuffer(data, ">u2", n_words).astype(np.uint64)
    s1 = s2 = 0
    for start in range(0, n_words, 360):
        block = words[start:start + 360]
        t = len(block)
        # sum2 += sum1 after each word: t * sum1 + sum_j (t - j) * w_j
        s2 = (s2 + t * s1 + int(np.dot(block, np.arange(t, 0, -1, dtype=np.uint64)))) & _M32
        s1 = (s1 + int(block.sum())) & _M32
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 = (s1 + (data[-1] << 8)) & _M32
        s2 = (s2 + s1) & _M32
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & _M32


# -- low-level reading ------------------------------------------------------

class _Cursor:
    """Little-endian fields out of one metadata block."""

    __slots__ = ("data", "pos", "osize", "lsize", "where")

    def __init__(self, data, osize, lsize, where, pos=0):
        self.data, self.pos, self.osize, self.lsize, self.where = data, pos, osize, lsize, where

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise HDF5Error(f"truncated {self.where}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def addr(self):
        v = self.uint(self.osize)
        return None if v == (1 << (8 * self.osize)) - 1 else v

    def length(self) -> int:
        return self.uint(self.lsize)

    def skip(self, n: int):
        self.take(n)

    def sig(self, expected: bytes):
        got = self.take(len(expected))
        if got != expected:
            raise HDF5Error(f"bad signature in {self.where}: {got!r}, expected {expected!r}")


def _check(block: bytes, where: str):
    """A block whose last 4 bytes are the lookup3 of the bytes before."""
    if len(block) < 4:
        raise HDF5Error(f"truncated {where}")
    stored = int.from_bytes(block[-4:], "little")
    if lookup3(block[:-4]) != stored:
        raise HDF5Error(f"checksum mismatch in {where}")


def _limit_enc_size(x: int) -> int:
    return max(x.bit_length() - 1, 0) // 8 + 1


def _log2(x: int) -> int:
    return x.bit_length() - 1


class _Store:
    """The open file: positioned reads, the file's address and length
    sizes, and caches of the heaps read so far."""

    def __init__(self, path: str, writable: bool):
        self.path = path
        self.fh = open(path, "r+b" if writable else "rb")
        try:
            self.size = os.fstat(self.fh.fileno()).st_size
            self._superblock()
        except BaseException:
            self.fh.close()
            raise
        self.gheaps = {}

    def close(self):
        self.fh.close()

    def read(self, addr: int, n: int, where: str) -> bytes:
        if addr is None:
            raise HDF5Error(f"undefined address for {where}")
        start = self.base + addr
        if start + n > self.size:
            raise HDF5Error(f"truncated file: {where} at {addr} needs {n} bytes, "
                            f"the file ends at {self.size - self.base}")
        return os.pread(self.fh.fileno(), n, start)

    def cursor(self, addr: int, n: int, where: str) -> _Cursor:
        return _Cursor(self.read(addr, n, where), self.osize, self.lsize, where)

    def cursor_at_most(self, addr: int, n: int, where: str) -> _Cursor:
        """Up to ``n`` bytes (less at the end of the file): for structures
        whose length is known only after their first fields."""
        if addr is None:
            raise HDF5Error(f"undefined address for {where}")
        n = max(0, min(n, self.size - self.base - addr))
        return _Cursor(os.pread(self.fh.fileno(), n, self.base + addr), self.osize,
                       self.lsize, where)

    def _superblock(self):
        offset = 0
        while True:
            if offset + 8 > self.size:
                raise HDF5Error(f"{self.path} is not an HDF5 file (no superblock signature)")
            if os.pread(self.fh.fileno(), 8, offset) == _SIGNATURE:
                break
            offset = 512 if offset == 0 else offset * 2
        self.sb_offset = offset
        head = os.pread(self.fh.fileno(), 256, offset)
        c = _Cursor(head, 8, 8, "superblock", 8)
        self.sb_version = version = c.uint(1)
        if version in (0, 1):
            c.skip(4)  # free-space, root group, reserved, shared header versions
            self.osize, self.lsize = c.uint(1), c.uint(1)
            c.skip(5)  # reserved, group leaf and internal node K
            c.skip(4)  # consistency flags
            if version == 1:
                c.skip(4)  # indexed storage K, reserved
            c.osize, c.lsize = self.osize, self.lsize
            c.addr()  # base address: the superblock's own offset is used
            c.addr()  # free-space info
            self.eof_field = offset + c.pos
            self.eof = c.addr()
            c.addr()  # the low-level I/O layer's information block
            _, root, _, _ = _symbol_entry(c)
            self.sb_end = offset + c.pos
        elif version in (2, 3):
            self.osize, self.lsize = c.uint(1), c.uint(1)
            c.skip(1)  # consistency flags
            c.osize, c.lsize = self.osize, self.lsize
            c.addr()  # base address, as above
            c.addr()  # superblock extension
            self.eof_field = offset + c.pos
            self.eof = c.addr()
            root = c.addr()
            self.sb_end = offset + c.pos + 4
            _check(head[:c.pos + 4], "superblock")
        else:
            raise UnsupportedFeature(f"superblock version {version}")
        if self.osize not in (2, 4, 8) or self.lsize not in (2, 4, 8):
            raise UnsupportedFeature(f"{self.osize}-byte addresses / {self.lsize}-byte lengths")
        # addresses count from the superblock (a user block may precede it),
        # whatever base address it records, as the HDF5 library reads them
        self.base = offset
        self.root = root
        if self.eof is not None and self.base + self.eof > self.size:
            raise HDF5Error(f"truncated file: {self.path} has {self.size} bytes, its "
                            f"superblock says {self.base + self.eof}")

    # the global heap: variable-length data
    def gheap_object(self, coll: int, index: int) -> bytes:
        objects = self.gheaps.get(coll)
        if objects is None:
            c = self.cursor(coll, 8 + self.lsize, "global heap collection")
            c.sig(b"GCOL")
            if c.uint(1) != 1:
                raise UnsupportedFeature("global heap collection version")
            c.skip(3)
            size = c.length()
            c = self.cursor(coll, size, "global heap collection")
            c.pos = hdr = 8 + self.lsize
            objects = {}
            while c.pos + hdr <= size:
                idx = c.uint(2)
                c.skip(6)  # reference count, reserved
                n = c.length()
                if idx == 0:
                    break
                objects[idx] = c.take(n)
                c.skip((-n) % 8)
            self.gheaps[coll] = objects
        try:
            return objects[index]
        except KeyError:
            raise HDF5Error(f"no object {index} in the global heap collection at {coll}") from None


def _symbol_entry(c: _Cursor):
    """(link name offset, object header address, cache type, scratch)."""
    name_off = c.uint(c.osize)
    addr = c.addr()
    cache = c.uint(4)
    c.skip(4)
    scratch = c.take(16)
    return name_off, addr, cache, scratch


# -- object headers ---------------------------------------------------------

class _Message:
    __slots__ = ("mtype", "flags", "data", "offset", "chunk", "corder")

    def __init__(self, mtype, flags, data, offset, chunk, corder=None):
        self.mtype, self.flags, self.data = mtype, flags, data
        self.offset, self.chunk, self.corder = offset, chunk, corder


class _Header:
    """A parsed object header: its messages, each with the file offset of
    its data and the (start, length) of its chunk when the chunk carries a
    checksum."""

    def __init__(self, store: _Store, addr: int):
        self.addr = addr
        self.messages = []
        head = store.cursor_at_most(addr, 16, f"object header at {addr}")
        if len(head.data) < 11:
            raise HDF5Error(f"truncated file: object header at {addr} lies past the end")
        if head.data[:4] == b"OHDR":
            self._v2(store, addr)
        elif head.data[:1] == b"\x01":
            self._v1(store, addr)
        else:
            raise HDF5Error(f"bad object header at {addr}")

    def _v1(self, store, addr):
        self.version = 1
        c = store.cursor(addr, 16, f"object header at {addr}")
        c.skip(2)
        n_msgs = c.uint(2)
        c.skip(4)  # reference count
        size = c.uint(4)
        chunks = [(addr + 16, size)]
        seen = 0
        while chunks and seen < n_msgs:
            start, size = chunks.pop(0)
            c = store.cursor(start, size, f"object header chunk at {start}")
            while c.pos + 8 <= size and seen < n_msgs:
                mtype, msize, mflags = c.uint(2), c.uint(2), c.uint(1)
                c.skip(3)
                data_at = c.pos
                data = c.take(msize)
                seen += 1
                self._add(store, mtype, mflags, data, start + data_at, None, None, chunks)
        if seen < n_msgs:
            raise HDF5Error(f"object header at {addr} holds {seen} of its {n_msgs} messages")

    def _v2(self, store, addr):
        self.version = 2
        c = store.cursor_at_most(addr, 6 + 16 + 4 + 8, f"object header at {addr}")
        c.sig(b"OHDR")
        if c.uint(1) != 2:
            raise UnsupportedFeature("object header version")
        self.flags = flags = c.uint(1)
        self.times = c.take(16) if flags & 0x20 else b""
        self.phase = c.take(4) if flags & 0x10 else b""
        size = c.uint(1 << (flags & 3))
        prefix = c.pos
        chunks = [(addr, prefix, prefix + size + 4, b"OHDR")]
        while chunks:
            start, first, total, sig = chunks.pop(0)
            block = store.read(start, total, f"object header chunk at {start}")
            if block[:4] != sig:
                raise HDF5Error(f"bad signature in object header chunk at {start}")
            _check(block, f"object header chunk at {start}")
            c = _Cursor(block[:-4], store.osize, store.lsize, f"object header at {addr}", first)
            hsize = 6 if flags & 0x04 else 4
            while c.pos + hsize <= len(c.data):
                mtype, msize, mflags = c.uint(1), c.uint(2), c.uint(1)
                corder = c.uint(2) if flags & 0x04 else None
                data_at = c.pos
                data = c.take(msize)
                self._add(store, mtype, mflags, data, start + data_at,
                          (start, total, total - 4), corder, chunks)

    def _add(self, store, mtype, mflags, data, offset, chunk, corder, chunks):
        if mtype == _CONTINUATION:
            c = _Cursor(data, store.osize, store.lsize, "continuation message")
            at, length = c.addr(), c.length()
            if self.version == 1:
                chunks.append((at, length))
            else:
                chunks.append((at, 4, length, b"OCHK"))
            return
        if mtype == _NIL:
            return
        self.messages.append(_Message(mtype, mflags, data, offset, chunk, corder))

    def find(self, mtype):
        return [m for m in self.messages if m.mtype == mtype]

    def one(self, mtype):
        found = self.find(mtype)
        if not found:
            return None
        m = found[0]
        if m.flags & 0x02:
            names = {_DATATYPE: "committed datatype"}
            raise UnsupportedFeature(names.get(mtype, f"shared object header message {mtype}"))
        return m


# -- datatypes, dataspaces, values -------------------------------------------

class _Type:
    """``kind`` "num" (a numpy dtype), "fstr" (fixed-length ``S`` dtype) or
    "vstr" (variable-length string, ``size`` bytes per element on disk)."""

    __slots__ = ("kind", "dtype", "size")

    def __init__(self, kind, dtype, size):
        self.kind, self.dtype, self.size = kind, dtype, size


def _datatype(c: _Cursor) -> _Type:
    b0 = c.uint(1)
    cls = b0 & 0x0F
    bits = c.uint(3)
    size = c.uint(4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = c.uint(2), c.uint(2)
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
            raise UnsupportedFeature(f"fixed-point type of {precision} bits at bit {offset} "
                                     f"in {size} bytes")
        return _Type("num", np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), size)
    if cls == 1:
        if bits & 0x40:
            raise UnsupportedFeature("VAX-order floating-point type")
        offset, precision = c.uint(2), c.uint(2)
        exp_loc, exp_size, mant_loc, mant_size = c.uint(1), c.uint(1), c.uint(1), c.uint(1)
        c.skip(4)  # exponent bias
        if offset != 0 or mant_loc != 0 or _IEEE.get(size) != (precision, exp_loc, exp_size,
                                                                 mant_size):
            raise UnsupportedFeature(f"non-IEEE floating-point type of {size} bytes")
        return _Type("num", np.dtype(f"{order}f{size}"), size)
    if cls == 3:
        return _Type("fstr", np.dtype(f"S{size}"), size)
    if cls == 9:
        if bits & 0x0F != 1:
            raise UnsupportedFeature("variable-length sequence type")
        _datatype(c)  # the base type (characters); ASCII and UTF-8 both read as UTF-8
        return _Type("vstr", None, size)
    raise UnsupportedFeature(f"{_TYPE_CLASS_NAMES.get(cls, f'class {cls}')} datatype")


def _dataspace(c: _Cursor) -> tuple:
    """The shape (the maximum shape that may follow is not needed)."""
    version, rank = c.uint(1), c.uint(1)
    c.skip(1)  # flags
    if version == 1:
        c.skip(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = c.uint(1)
    else:
        raise UnsupportedFeature(f"dataspace version {version}")
    if kind == 2:
        raise UnsupportedFeature("null dataspace")
    return tuple(c.length() for _ in range(rank))


def _values(store: _Store, t: _Type, shape: tuple, raw: bytes):
    """Decoded elements: a numpy scalar, ``np.bytes_`` or ``str`` for a
    scalar dataspace, an array otherwise (as h5py returns them)."""
    n = int(np.prod(shape, dtype=np.int64))
    if len(raw) < n * t.size:
        raise HDF5Error(f"truncated data: {len(raw)} bytes for {n} elements of {t.size}")
    if t.kind == "vstr":
        out = []
        for i in range(n):
            c = _Cursor(raw, store.osize, store.lsize, "variable-length string", i * t.size)
            length, coll, index = c.uint(4), c.addr(), c.uint(4)
            if length == 0 or coll in (None, 0):
                out.append("")
                continue
            out.append(store.gheap_object(coll, index)[:length].decode("utf-8"))
        if shape == ():
            return out[0]
        arr = np.empty(n, object)
        arr[:] = out
        return arr.reshape(shape)
    arr = np.frombuffer(raw, t.dtype, n).reshape(shape).copy()
    return arr[()] if shape == () else arr


def _attribute(store: _Store, data: bytes):
    """(name, value) of an encoded attribute message."""
    c = _Cursor(data, store.osize, store.lsize, "attribute message")
    version, flags = c.uint(1), c.uint(1)
    name_size, type_size, space_size = c.uint(2), c.uint(2), c.uint(2)
    if version not in (1, 2, 3):
        raise UnsupportedFeature(f"attribute message version {version}")
    if flags & 0x01:
        raise UnsupportedFeature("committed datatype")
    if flags & 0x02:
        raise UnsupportedFeature("shared dataspace")
    if version == 3:
        c.skip(1)  # name character set
    pad = (lambda n: n + (-n) % 8) if version == 1 else (lambda n: n)
    name = c.take(pad(name_size))[:name_size].rstrip(b"\x00").decode("utf-8")
    tc = _Cursor(c.take(pad(type_size)), store.osize, store.lsize, f"attribute {name!r}")
    t = _datatype(tc)
    sc = _Cursor(c.take(pad(space_size)), store.osize, store.lsize, f"attribute {name!r}")
    return name, _values(store, t, _dataspace(sc), data[c.pos:])


# -- fractal heap and v2 B-tree (dense links and attributes) -----------------

class _FractalHeap:
    def __init__(self, store: _Store, addr: int):
        self.store = store
        where = f"fractal heap at {addr}"
        c = store.cursor_at_most(addr, 200, where)
        c.sig(b"FRHP")
        if c.uint(1) != 0:
            raise UnsupportedFeature("fractal heap version")
        self.id_len, filter_len, self.flags = c.uint(2), c.uint(2), c.uint(1)
        max_man = c.uint(4)
        c.length()  # next huge ID
        c.addr()  # huge objects' B-tree
        c.length()
        c.addr()  # free-space manager
        for _ in range(8):
            c.length()  # managed space, allocated, iterator, counts and sizes
        self.width = c.uint(2)
        self.start_size, self.max_direct = c.length(), c.length()
        max_bits = c.uint(2)
        c.uint(2)  # starting rows in the root indirect block
        self.root = c.addr()
        self.root_rows = c.uint(2)
        if filter_len:
            raise UnsupportedFeature("filtered fractal heap")
        _check(c.data[:c.pos + 4], where)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8, _limit_enc_size(max_man))
        self.max_direct_rows = _log2(self.max_direct) - _log2(self.start_size) + 2
        self.blocks = None  # [(heap offset, address, size)] of the direct blocks
        self.block_cache = {}

    def _row_size(self, row: int) -> int:
        return self.start_size if row == 0 else self.start_size << (row - 1)

    def _dblock_header(self) -> int:
        return 5 + self.store.osize + self.off_size + (4 if self.flags & 0x02 else 0)

    def _walk(self, addr, nrows, offset, out):
        s = self.store
        n_direct = min(nrows, self.max_direct_rows) * self.width
        n_indirect = max(nrows - self.max_direct_rows, 0) * self.width
        size = 5 + s.osize + self.off_size + (n_direct + n_indirect) * s.osize + 4
        block = s.read(addr, size, "fractal heap indirect block")
        if block[:4] != b"FHIB":
            raise HDF5Error(f"bad signature in fractal heap indirect block at {addr}")
        _check(block, f"fractal heap indirect block at {addr}")
        c = _Cursor(block, s.osize, s.lsize, "fractal heap indirect block", 5 + s.osize)
        c.skip(self.off_size)
        for row in range(nrows):
            rsize = self._row_size(row)
            for _ in range(self.width):
                child = c.addr()
                if child is not None:
                    if row < self.max_direct_rows:
                        out.append((offset, child, rsize))
                    else:
                        child_rows = _log2(rsize) - _log2(self.start_size * self.width) + 1
                        self._walk(child, child_rows, offset, out)
                offset += rsize

    def _direct_blocks(self):
        if self.blocks is None:
            out = []
            if self.root is not None:
                if self.root_rows == 0:
                    out.append((0, self.root, self.start_size))
                else:
                    self._walk(self.root, self.root_rows, 0, out)
            self.blocks = out
        return self.blocks

    def _block(self, addr, size):
        block = self.block_cache.get(addr)
        if block is None:
            where = f"fractal heap direct block at {addr}"
            block = self.store.read(addr, size, where)
            if block[:4] != b"FHDB":
                raise HDF5Error(f"bad signature in {where}")
            if self.flags & 0x02:
                at = 5 + self.store.osize + self.off_size
                stored = int.from_bytes(block[at:at + 4], "little")
                if lookup3(block[:at] + bytes(4) + block[at + 4:]) != stored:
                    raise HDF5Error(f"checksum mismatch in {where}")
            self.block_cache[addr] = block
        return block

    def get(self, heap_id: bytes):
        """(object bytes, file address of the object, (block address, block
        size, checksum offset) when the block is checksummed)."""
        kind = (heap_id[0] >> 4) & 0x03
        if heap_id[0] >> 6:
            raise UnsupportedFeature("fractal heap ID version")
        if kind == 2:  # tiny: the object is inside the ID
            if self.id_len <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return heap_id[1:1 + n], None, None
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return heap_id[2:2 + n], None, None
        if kind != 0:
            raise UnsupportedFeature("huge fractal heap object")
        off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        n = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size + self.len_size], "little")
        for start, addr, size in self._direct_blocks():
            if start <= off < start + size:
                block = self._block(addr, size)
                at = off - start
                if at < self._dblock_header() or at + n > size:
                    break
                region = (addr, size, 5 + self.store.osize + self.off_size) \
                    if self.flags & 0x02 else None
                return block[at:at + n], addr + at, region
        raise HDF5Error(f"fractal heap object at heap offset {off} is outside every block")


def _btree2_records(store: _Store, addr: int):
    """Every record of a v2 B-tree, in key order."""
    where = f"v2 B-tree at {addr}"
    c = store.cursor_at_most(addr, 64, where)
    c.sig(b"BTHD")
    if c.uint(1) != 0:
        raise UnsupportedFeature("v2 B-tree version")
    c.uint(1)  # record type
    node_size, rec_size, depth = c.uint(4), c.uint(2), c.uint(2)
    c.skip(2)
    root, root_nrec = c.addr(), c.uint(2)
    c.length()
    _check(c.data[:c.pos + 4], where)
    # node_info of H5B2__hdr_init: records per node and bytes of the counts
    max_nrec = [(node_size - 10) // rec_size]
    cum_max = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _limit_enc_size(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = store.osize + nrec_size + cum_size[d - 1]
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
        cum_size.append(_limit_enc_size(cum_max[d]))
    out = []

    def node(at, nrec, d):
        sig = b"BTIN" if d else b"BTLF"
        n = 6 + nrec * rec_size
        if d:
            n += (nrec + 1) * (store.osize + nrec_size + cum_size[d - 1])
        block = store.read(at, n + 4, f"v2 B-tree node at {at}")
        if block[:4] != sig:
            raise HDF5Error(f"bad signature in v2 B-tree node at {at}")
        _check(block, f"v2 B-tree node at {at}")
        records = [block[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(nrec)]
        if not d:
            out.extend(records)
            return
        cc = _Cursor(block, store.osize, store.lsize, "v2 B-tree node", 6 + nrec * rec_size)
        children = []
        for _ in range(nrec + 1):
            child, child_nrec = cc.addr(), cc.uint(nrec_size)
            cc.skip(cum_size[d - 1])
            children.append((child, child_nrec))
        for i, (child, child_nrec) in enumerate(children):
            node(child, child_nrec, d - 1)
            if i < nrec:
                out.append(records[i])

    if root is not None and root_nrec:
        node(root, root_nrec, depth)
    return out


# -- groups ------------------------------------------------------------------

def _link(store: _Store, data: bytes):
    """(name, hard-link address or None, offset of the address in data,
    link kind)."""
    c = _Cursor(data, store.osize, store.lsize, "link message")
    if c.uint(1) != 1:
        raise UnsupportedFeature("link message version")
    flags = c.uint(1)
    kind = c.uint(1) if flags & 0x08 else 0
    if flags & 0x04:
        c.skip(8)
    if flags & 0x10:
        c.skip(1)
    name = c.take(c.uint(1 << (flags & 3))).decode("utf-8")
    if kind != 0:
        return name, None, None, {1: "soft link", 64: "external link"}.get(kind, f"link type {kind}")
    at = c.pos
    return name, c.addr(), at, "hard"


class _Link:
    """Where a child is named in its parent: its header address and the
    file offset of that address (with the checksummed region holding it)."""

    __slots__ = ("addr", "kind", "site", "region", "region_kind")

    def __init__(self, addr, kind, site=None, region=None, region_kind=None):
        self.addr, self.kind, self.site = addr, kind, site
        self.region, self.region_kind = region, region_kind


def _symbol_table_links(store: _Store, btree: int, heap: int) -> dict:
    c = store.cursor(heap, 8 + 2 * store.lsize + store.osize, f"local heap at {heap}")
    c.sig(b"HEAP")
    c.skip(4)
    seg_size = c.length()
    c.length()
    names = store.read(c.addr(), seg_size, "local heap data segment")
    entry_size = 2 * store.osize + 24
    links = {}

    def name_at(off):
        end = names.find(b"\x00", off)
        if off >= len(names) or end < 0:
            raise HDF5Error(f"bad name offset {off} in local heap at {heap}")
        return names[off:end].decode("utf-8")

    def walk(at, expect=None):
        c = store.cursor(at, 8 + 2 * store.osize, f"v1 B-tree node at {at}")
        c.sig(b"TREE")
        if c.uint(1) != 0:
            raise HDF5Error(f"v1 B-tree node at {at} is not a group node")
        level, n = c.uint(1), c.uint(2)
        if expect not in (None, level):
            raise HDF5Error(f"v1 B-tree node at {at} has level {level}, expected {expect}")
        size = 8 + 2 * store.osize + n * store.osize + (n + 1) * store.lsize
        c = store.cursor(at, size, f"v1 B-tree node at {at}")
        c.pos = 8 + 2 * store.osize
        children = []
        for _ in range(n):
            c.length()
            children.append(c.addr())
        for child in children:
            if level:
                walk(child, level - 1)
                continue
            s = store.cursor(child, 8, f"symbol table node at {child}")
            s.sig(b"SNOD")
            s.skip(2)
            count = s.uint(2)
            s = store.cursor(child, 8 + count * entry_size, f"symbol table node at {child}")
            s.pos = 8
            for i in range(count):
                name_off, addr, _, _ = _symbol_entry(s)
                site = child + 8 + i * entry_size + store.osize
                links[name_at(name_off)] = _Link(addr, "hard", site)

    walk(btree)
    return links


def _sorted_names(names):
    return sorted(names, key=lambda n: n.encode("utf-8"))


class Attributes:
    """A group's or dataset's attributes, h5py's ``attrs``: read lazily,
    writable where the file is."""

    def __init__(self, store, items: dict, writable: bool, on_change=None):
        self._store = store
        self._items = items  # name -> ("raw", message bytes) or ("new", value)
        self._writable = writable
        self._on_change = on_change

    def keys(self):
        return _sorted_names(self._items)

    def __contains__(self, name):
        return name in self._items

    def __getitem__(self, name):
        kind, v = self._items[name]
        return _attribute(self._store, v)[1] if kind == "raw" else v

    def get(self, name, default=None):
        return self[name] if name in self._items else default

    def __setitem__(self, name, value):
        if not self._writable:
            raise HDF5Error("the file is open read-only")
        _encode_value(value)  # refuse what cannot be written now, not at close
        self._items[name] = ("new", value)
        if self._on_change:
            self._on_change()

    def __delitem__(self, name):
        if not self._writable:
            raise HDF5Error("the file is open read-only")
        del self._items[name]
        if self._on_change:
            self._on_change()


class _Object:
    def __init__(self, file, header: _Header, link: _Link):
        self.file, self._header, self._link = file, header, link
        self._attrs = None

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            store = self.file._store
            items = {}
            for m in self._header.find(_ATTRIBUTE):
                name = _attribute_name(store, m.data)
                items[name] = ("raw", m.data)
            info = self._header.one(_ATTR_INFO)
            if info is not None:
                c = _Cursor(info.data, store.osize, store.lsize, "attribute info message")
                c.skip(1)
                flags = c.uint(1)
                if flags & 0x01:
                    c.skip(2)
                heap_addr, name_tree = c.addr(), c.addr()
                if heap_addr is not None:
                    heap = _FractalHeap(store, heap_addr)
                    for rec in _btree2_records(store, name_tree):
                        if rec[8] & 0x02:
                            raise UnsupportedFeature("shared attribute message")
                        data = heap.get(rec[:8])[0]
                        items[_attribute_name(store, data)] = ("raw", data)
            self._attrs = Attributes(store, items, self.file._writable,
                                     lambda: self.file._dirty.__setitem__(id(self), self))
        return self._attrs


def _attribute_name(store, data: bytes) -> str:
    c = _Cursor(data, store.osize, store.lsize, "attribute message")
    version = c.uint(1)
    c.skip(1)
    n = c.uint(2)
    c.skip(4)
    if version == 3:
        c.skip(1)
    return c.take(n).rstrip(b"\x00").decode("utf-8")


class Group(_Object):
    """A group of an open file."""

    def __init__(self, file, header, link):
        super().__init__(file, header, link)
        self._links = None

    def _children(self) -> dict:
        if self._links is None:
            store = self.file._store
            stab = self._header.one(_SYMBOL_TABLE)
            if stab is not None:
                c = _Cursor(stab.data, store.osize, store.lsize, "symbol table message")
                links = _symbol_table_links(store, c.addr(), c.addr())
            else:
                links = {}
                for m in self._header.find(_LINK):
                    name, addr, at, kind = _link(store, m.data)
                    links[name] = _Link(addr, kind, None if at is None else m.offset + at,
                                        m.chunk, "chunk")
                info = self._header.one(_LINK_INFO)
                if info is not None:
                    c = _Cursor(info.data, store.osize, store.lsize, "link info message")
                    c.skip(1)
                    if c.uint(1) & 0x01:
                        c.skip(8)
                    heap_addr, name_tree = c.addr(), c.addr()
                    if heap_addr is not None:
                        heap = _FractalHeap(store, heap_addr)
                        for rec in _btree2_records(store, name_tree):
                            data, obj_at, region = heap.get(rec[4:])
                            name, addr, at, kind = _link(store, data)
                            site = None if (at is None or obj_at is None) else obj_at + at
                            links[name] = _Link(addr, kind, site, region, "heap")
            self._links = links
        return self._links

    def keys(self):
        return _sorted_names(self._children())

    def __contains__(self, name):
        try:
            self._resolve(name)
        except KeyError:
            return False
        return True

    def _resolve(self, name: str) -> _Link:
        group = self
        parts = [p for p in name.split("/") if p]
        for i, part in enumerate(parts):
            link = group._children().get(part)
            if link is None:
                raise KeyError(f"no object {name!r}")
            if i + 1 < len(parts):
                group = group.file._open(link, name)
                if not isinstance(group, Group):
                    raise KeyError(f"no object {name!r}")
        return link

    def __getitem__(self, name: str):
        return self.file._open(self._resolve(name), name)


class Dataset(_Object):
    """A dataset of an open file: ``shape``, ``ndim``, ``dtype`` and
    reads through ``[...]``."""

    def __init__(self, file, header, link):
        super().__init__(file, header, link)
        store = file._store
        if header.find(_EXTERNAL):
            raise UnsupportedFeature("external data storage")
        where = f"dataset at {header.addr}"
        self.shape = _dataspace(_Cursor(header.one(_DATASPACE).data, store.osize, store.lsize,
                                        where))
        t = _datatype(_Cursor(header.one(_DATATYPE).data, store.osize, store.lsize, where))
        if t.kind == "vstr":
            raise UnsupportedFeature("variable-length string dataset")
        self.dtype = t.dtype
        self.ndim = len(self.shape)
        self.size = int(np.prod(self.shape, dtype=np.int64))
        self._fill = _fill_value(header, t)
        self._filters = _filters(header)
        self._layout(header.one(_LAYOUT), store, where)

    def _layout(self, m, store, where):
        if m is None:
            raise HDF5Error(f"no layout message in {where}")
        c = _Cursor(m.data, store.osize, store.lsize, where)
        version = c.uint(1)
        self.chunks = None
        if version in (1, 2):
            rank, cls = c.uint(1), c.uint(1)
            c.skip(5)
            addr = c.addr() if cls != 0 else None
            dims = [c.uint(4) for _ in range(rank)]
            if cls == 2:
                self._chunk_layout(dims[:-1], "btree1", addr)
            elif cls == 1:
                self._kind, self._addr = "contiguous", addr
            else:
                self._kind, self._data = "compact", c.take(c.uint(4))
            return
        if version not in (3, 4):
            raise UnsupportedFeature(f"data layout version {version}")
        cls = c.uint(1)
        if cls == 0:
            self._kind, self._data = "compact", c.take(c.uint(2))
        elif cls == 1:
            self._kind, self._addr = "contiguous", c.addr()
            c.length()
        elif cls == 2 and version == 3:
            rank = c.uint(1)
            addr = c.addr()
            dims = [c.uint(4) for _ in range(rank)]
            self._chunk_layout(dims[:-1], "btree1", addr)
        elif cls == 2:
            flags, rank, enc = c.uint(1), c.uint(1), c.uint(1)
            dims = [c.uint(enc) for _ in range(rank)]
            index = c.uint(1)
            if flags & 0x01:
                raise UnsupportedFeature("unfiltered partial edge chunks")
            if index == 1:
                filtered = (c.length(), c.uint(4)) if flags & 0x02 else None
                self._chunk_layout(dims[:-1], "single", c.addr(), filtered)
            elif index == 3:
                c.skip(1)  # page bits (the fixed array's header has them)
                self._chunk_layout(dims[:-1], "farray", c.addr())
            else:
                names = {2: "implicit chunk index", 4: "extensible-array chunk index",
                         5: "v2 B-tree chunk index"}
                raise UnsupportedFeature(names.get(index, f"chunk index type {index}"))
        elif cls == 3:
            raise UnsupportedFeature("virtual dataset layout")
        else:
            raise HDF5Error(f"unknown layout class {cls} in {where}")
        if self._kind == "contiguous" and self._addr is not None:
            end = self._addr + self.size * self.dtype.itemsize
            if self.file._store.base + end > self.file._store.size:
                raise HDF5Error(f"truncated file: the data of {where} ends at {end}, "
                                f"the file at {self.file._store.size}")
        if self._kind == "compact" and len(self._data) < self.size * self.dtype.itemsize:
            raise HDF5Error(f"truncated compact data in {where}")

    def _chunk_layout(self, dims, index, addr, filtered=None):
        self._kind, self._index, self._addr, self._single = "chunked", index, addr, filtered
        self.chunks = tuple(dims)
        self._chunk_map = None
        if len(dims) != self.ndim:
            raise HDF5Error("chunk rank differs from the dataspace's")

    def __getitem__(self, key):
        sel = _selection(key, self.shape)
        out_shape = tuple(len(range(*s)) for s in sel if not isinstance(s, int))
        if self._kind == "compact":
            arr = np.frombuffer(self._data, self.dtype, self.size).reshape(self.shape)
            return arr[_np_key(sel)].copy()
        if self._kind == "contiguous":
            if self._addr is None:
                return np.full(out_shape, self._fill, self.dtype)[()]
            if self.size == 0:
                return np.empty(out_shape, self.dtype)
            store = self.file._store
            mm = np.memmap(store.fh, self.dtype, "r", store.base + self._addr, self.shape)
            try:
                out = np.array(mm[_np_key(sel)])
            finally:
                del mm
            return out[()] if out.ndim == 0 else out
        return self._read_chunked(sel, out_shape)

    # chunked reads
    def _chunk_addresses(self):
        """{chunk origin (element offsets): (address, stored size, filter mask)}."""
        store = self.file._store
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        if self._addr is None:
            return {}
        if self._index == "single":
            size, mask = self._single if self._single else (nbytes, 0)
            return {(0,) * self.ndim: (self._addr, size, mask)}
        if self._index == "btree1":
            return _btree1_chunks(store, self._addr, self.ndim)
        return _farray_chunks(store, self._addr, self.shape, self.chunks, nbytes)

    def _read_chunked(self, sel, out_shape):
        store = self.file._store
        if self._chunk_map is None:
            self._chunk_map = self._chunk_addresses()
        ranges = [range(s, s + 1) if isinstance(s, int) else range(*s) for s in sel]
        out = np.empty([len(r) for r in ranges], self.dtype)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        if out.size:
            per_dim = [range(r[0] // c, r[-1] // c + 1) for r, c in zip(ranges, self.chunks)]
            for grid in np.ndindex(*[len(p) for p in per_dim]):
                origin = tuple(p[g] * c for p, g, c in zip(per_dim, grid, self.chunks))
                src, dst = [], []
                for r, o, c in zip(ranges, origin, self.chunks):
                    # the selected positions k with o <= r[k] < o + c
                    k0 = max(0, -(-(o - r.start) // r.step))
                    k1 = min(len(r), -(-(o + c - r.start) // r.step))
                    src.append(slice(r[k0] - o, r[k1 - 1] - o + 1, r.step) if k0 < k1 else None)
                    dst.append(slice(k0, k1))
                if None in src:
                    continue  # a step that jumps over this chunk
                entry = self._chunk_map.get(origin)
                if entry is None:
                    out[tuple(dst)] = self._fill
                    continue
                addr, size, mask = entry
                raw = _decode_chunk(store.read(addr, size, f"chunk at {addr}"), self._filters,
                                    mask, nbytes, addr)
                chunk = np.frombuffer(raw, self.dtype).reshape(self.chunks)
                out[tuple(dst)] = chunk[tuple(src)]
        return out.reshape(out_shape)[()] if out_shape else out.reshape(())[()]


def _selection(key, shape):
    """Basic indexing normalized to one ``int`` or (start, stop, step) per
    dimension."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = next(j for j, k in enumerate(key) if k is Ellipsis)
        rest = [k for k in key[i + 1:]]
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + tuple(rest)
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for {len(shape)} dimensions")
    key = key + (slice(None),) * (len(shape) - len(key))
    out = []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("a slice step must be >= 1")
            out.append((start, max(stop, start), step))
        elif isinstance(k, (int, np.integer)):
            k = int(k)
            if not -n <= k < n:
                raise IndexError(f"index {k} out of range for a dimension of {n}")
            out.append(k % n)
        else:
            raise TypeError(f"only basic indexing is supported, got {k!r}")
    return out


def _np_key(sel):
    return tuple(s if isinstance(s, int) else slice(*s) for s in sel)


def _fill_value(header: _Header, t: _Type):
    m = header.one(_FILL)
    store_raw = None
    if m is not None:
        c = _Cursor(m.data, 8, 8, "fill value message")
        version = c.uint(1)
        if version in (1, 2):
            c.skip(2)
            if c.uint(1):
                store_raw = c.take(c.uint(4))
        else:
            flags = c.uint(1)
            if flags & 0x20:
                store_raw = c.take(c.uint(4))
    elif (m := header.one(_FILL_OLD)) is not None:
        c = _Cursor(m.data, 8, 8, "fill value message")
        store_raw = c.take(c.uint(4))
    if not store_raw:
        return np.zeros((), t.dtype)[()]
    if len(store_raw) != t.size:
        raise HDF5Error(f"a fill value of {len(store_raw)} bytes for elements of {t.size}")
    return np.frombuffer(store_raw, t.dtype, 1)[0]


def _filters(header: _Header):
    """[(filter id, client data)] in the order applied when writing."""
    m = header.one(_FILTERS)
    if m is None:
        return []
    c = _Cursor(m.data, 8, 8, "filter pipeline message")
    version, n = c.uint(1), c.uint(1)
    if version == 1:
        c.skip(6)
    out = []
    for _ in range(n):
        fid = c.uint(2)
        name_len = c.uint(2) if version == 1 or fid >= 256 else 0
        c.uint(2)  # flags
        n_values = c.uint(2)
        c.skip(name_len + ((-name_len) % 8 if version == 1 else 0))
        values = [c.uint(4) for _ in range(n_values)]
        if version == 1 and n_values % 2:
            c.skip(4)
        if fid not in (1, 2, 3):
            raise UnsupportedFeature(f"filter {_FILTER_NAMES.get(fid, 'id')} (id {fid})")
        out.append((fid, values))
    return out


def _decode_chunk(raw: bytes, filters, mask: int, nbytes: int, addr: int) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, values = filters[i]
        if fid == 1:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise HDF5Error(f"deflate failed on the chunk at {addr}: {e}") from None
        elif fid == 2:
            size = values[0] if values else 1
            n = len(raw) // size
            body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T
            raw = body.tobytes() + raw[n * size:]
        else:
            if len(raw) < 4:
                raise HDF5Error(f"truncated fletcher32 chunk at {addr}")
            stored = int.from_bytes(raw[-4:], "little")
            raw = raw[:-4]
            got = fletcher32(raw)
            if stored != got and stored != int.from_bytes(got.to_bytes(4, "little"), "big"):
                raise HDF5Error(f"fletcher32 checksum mismatch in the chunk at {addr}")
    if len(raw) != nbytes:
        raise HDF5Error(f"the chunk at {addr} decodes to {len(raw)} bytes, expected {nbytes}")
    return raw


def _btree1_chunks(store: _Store, addr: int, ndim: int) -> dict:
    out = {}
    key_size = 8 + 8 * (ndim + 1)

    def walk(at, expect=None):
        c = store.cursor(at, 8 + 2 * store.osize, f"v1 B-tree node at {at}")
        c.sig(b"TREE")
        if c.uint(1) != 1:
            raise HDF5Error(f"v1 B-tree node at {at} is not a chunk node")
        level, n = c.uint(1), c.uint(2)
        if expect not in (None, level):
            raise HDF5Error(f"v1 B-tree node at {at} has level {level}, expected {expect}")
        c = store.cursor(at, 8 + 2 * store.osize + n * (key_size + store.osize) + key_size,
                         f"v1 B-tree node at {at}")
        c.pos = 8 + 2 * store.osize
        for _ in range(n):
            size, mask = c.uint(4), c.uint(4)
            origin = tuple(c.uint(8) for _ in range(ndim + 1))[:ndim]
            child = c.addr()
            if level:
                walk(child, level - 1)
            else:
                out[origin] = (child, size, mask)

    walk(addr)
    return out


def _farray_chunks(store: _Store, addr: int, shape, chunks, nbytes) -> dict:
    where = f"fixed array at {addr}"
    c = store.cursor_at_most(addr, 32 + store.lsize + store.osize, where)
    c.sig(b"FAHD")
    if c.uint(1) != 0:
        raise UnsupportedFeature("fixed array version")
    client, esize, page_bits = c.uint(1), c.uint(1), c.uint(1)
    n = c.length()
    dblock = c.addr()
    _check(c.data[:c.pos + 4], where)
    if dblock is None:
        return {}
    page_n = 1 << page_bits
    n_pages = -(-n // page_n) if n > page_n else 0
    bitmap_size = (n_pages + 7) // 8
    prefix = 6 + store.osize + bitmap_size
    if n_pages:
        head = store.read(dblock, prefix + 4, f"fixed array data block at {dblock}")
        raw, bitmap = b"", head[6 + store.osize:prefix]
        if head[:4] != b"FADB":
            raise HDF5Error(f"bad signature in fixed array data block at {dblock}")
        _check(head, f"fixed array data block at {dblock}")
        for p in range(n_pages):
            count = min(page_n, n - p * page_n)
            if not bitmap[p // 8] & (0x80 >> (p % 8)):
                raw += b"\xff" * (count * esize)  # page never written: no chunk
                continue
            at = dblock + prefix + 4 + p * (page_n * esize + 4)
            page = store.read(at, count * esize + 4, f"fixed array page at {at}")
            _check(page, f"fixed array page at {at}")
            raw += page[:-4]
    else:
        block = store.read(dblock, prefix + n * esize + 4, f"fixed array data block at {dblock}")
        if block[:4] != b"FADB":
            raise HDF5Error(f"bad signature in fixed array data block at {dblock}")
        _check(block, f"fixed array data block at {dblock}")
        raw = block[prefix:-4]
    grid = [-(-s // cdim) for s, cdim in zip(shape, chunks)]
    out = {}
    c = _Cursor(raw, store.osize, store.lsize, where)
    for i in range(n):
        chunk_addr = c.addr()
        if client == 1:
            size = c.uint(esize - store.osize - 4)
            mask = c.uint(4)
        else:
            size, mask = nbytes, 0
        if chunk_addr is None:
            continue
        origin = np.unravel_index(i, grid)
        out[tuple(int(g) * cdim for g, cdim in zip(origin, chunks))] = (chunk_addr, size, mask)
    return out


def is_group(obj) -> bool:
    return isinstance(obj, Group)


def is_dataset(obj) -> bool:
    return isinstance(obj, Dataset)


# -- writing -----------------------------------------------------------------

_UNDEF = b"\xff" * 8


def _pad8(b: bytes) -> bytes:
    return b + bytes((-len(b)) % 8)


def _enc_datatype(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    big = dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian)
    if dtype.kind in "iu":
        bits = (1 if big else 0) | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        precision, exp_loc, exp_size, mant_size = _IEEE[dtype.itemsize]
        bias = (1 << (exp_size - 1)) - 1
        bits = bytes([0x20 | (1 if big else 0), precision - 1, 0])
        return struct.pack("<B3sIHHBBBBI", 0x11, bits, dtype.itemsize, 0, precision, exp_loc,
                           exp_size, 0, mant_size, bias)
    if dtype.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([0x01, 0, 0]), dtype.itemsize)
    raise UnsupportedFeature(f"writing a {dtype} value")


def _vstr_type(osize: int) -> bytes:
    """A variable-length UTF-8 string of null-terminated characters."""
    return (struct.pack("<B3sI", 0x19, bytes([0x01, 0x01, 0]), 8 + osize)
            + struct.pack("<B3sIHH", 0x10, bytes([0, 0, 0]), 1, 0, 8))


def _enc_dataspace(shape) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", int(n)) for n in shape)


def _encode_value(value):
    """(datatype bytes or None for a string, shape, data or the str)."""
    if isinstance(value, str):
        return None, (), value
    if isinstance(value, bool) or isinstance(value, np.bool_):
        raise UnsupportedFeature("writing a boolean attribute (an HDF5 enum)")
    if isinstance(value, int):
        value = np.int64(value)
    elif isinstance(value, float):
        value = np.float64(value)
    arr = np.asarray(value)
    if arr.dtype.kind not in "iufS":
        raise UnsupportedFeature(f"writing a {arr.dtype} attribute")
    return _enc_datatype(arr.dtype), arr.shape, arr.tobytes()


def _attribute_message(name: str, value, heap_ids: dict, osize: int) -> bytes:
    dt, shape, data = _encode_value(value)
    if dt is None:  # (length, collection, index); an empty string is a null ID
        dt = _vstr_type(osize)
        raw = data.encode("utf-8")
        coll, index = heap_ids[id(value)] if raw else (0, 0)
        data = struct.pack("<I", len(raw)) + coll.to_bytes(osize, "little") + struct.pack(
            "<I", index)
    ds = _enc_dataspace(shape)
    bname = name.encode("utf-8") + b"\x00"
    return struct.pack("<BBHHHB", 3, 0, len(bname), len(dt), len(ds), 1) + bname + dt + ds + data


def _gcol(strings: list, at: int, lsize: int = 8) -> tuple[bytes, dict]:
    """A global heap collection holding ``strings`` (objects 1..n) and the
    free space after them: (bytes, {id(str): (collection address, index)})."""
    body, ids = b"", {}
    for i, s in enumerate(strings, start=1):
        raw = s.encode("utf-8")
        body += struct.pack("<HH4xQ", i, 1, len(raw)) + _pad8(raw)
        ids[id(s)] = (at, i)
    size = max(4096, 16 + len(body) + 16)
    free = size - 16 - len(body)
    body += struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
    return b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body, ids


def _ohdr_v1(messages) -> bytes:
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), f) + _pad8(d) for t, f, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _ohdr_v2(messages, flags: int, times: bytes, phase: bytes) -> bytes:
    flags = (flags & 0x3C) | 0x02  # a 4-byte chunk size
    body = b""
    for i, (t, f, d, corder) in enumerate(messages):
        body += struct.pack("<BHB", t, len(d), f)
        if flags & 0x04:
            body += struct.pack("<H", i if corder is None else corder)
        body += d
    blob = b"OHDR" + bytes([2, flags]) + times + phase + struct.pack("<I", len(body)) + body
    return blob + struct.pack("<I", lookup3(blob))


class _NewDataset:
    def __init__(self, data):
        self.data = np.asarray(data, order="C")  # a 0-d array stays 0-d
        _enc_datatype(self.data.dtype)  # refuse a type it cannot write now


class _NewGroup:
    """A group of a file being written (mode ``"w"``)."""

    def __init__(self):
        self.children = {}
        self.attrs = Attributes(None, {}, True)

    def create_group(self, name: str) -> "_NewGroup":
        if name in self.children:
            raise ValueError(f"name {name!r} already exists")
        g = self.children[name] = _NewGroup()
        return g

    def create_dataset(self, name: str, data) -> _NewDataset:
        if name in self.children:
            raise ValueError(f"name {name!r} already exists")
        d = self.children[name] = _NewDataset(data)
        return d

    def keys(self):
        return _sorted_names(self.children)


class _Writer:
    """Appends 8-byte-aligned blocks to a new file."""

    def __init__(self, fh, start: int):
        self.fh, self.pos = fh, start

    def put(self, data) -> int:
        pad = (-self.pos) % 8
        if pad:
            self.fh.write(bytes(pad))
            self.pos += pad
        at = self.pos
        self.fh.write(data)
        self.pos += memoryview(data).nbytes
        return at


_LEAF_K, _INTERNAL_K = 4, 16
_SB_SIZE = 96
_ENTRY = 40


def _write_group(w: _Writer, g: _NewGroup, heap_ids: dict):
    """Write a group and everything below it; (header address, B-tree
    address, heap address)."""
    entries = []
    for name in g.keys():
        child = g.children[name]
        if isinstance(child, _NewGroup):
            addr, btree, heap = _write_group(w, child, heap_ids)
            entries.append((name, addr, 1, struct.pack("<QQ", btree, heap)))
        else:
            addr = _write_dataset(w, child)
            entries.append((name, addr, 0, bytes(16)))
    # local heap: "" at 0, then each name
    names, offsets = bytearray(8), []
    for name, *_ in entries:
        offsets.append(len(names))
        names += _pad8(name.encode("utf-8") + b"\x00")
    seg = w.put(bytes(names))
    heap = w.put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(names), 1, seg))
    # symbol table nodes of up to 2K entries, then B-tree levels of up to 2K children
    node_size = 8 + 2 * _LEAF_K * _ENTRY
    level = []  # (address, offset of the greatest name below)
    for i in range(0, len(entries), 2 * _LEAF_K):
        part = entries[i:i + 2 * _LEAF_K]
        body = b"".join(struct.pack("<QQI4x", offsets[i + j], addr, cache) + scratch
                        for j, (_, addr, cache, scratch) in enumerate(part))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
        level.append((w.put(snod + bytes(node_size - len(snod))),
                      offsets[i + len(part) - 1]))
    tree_size = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
    depth = 0
    while True:
        parts = [level[i:i + 2 * _INTERNAL_K] for i in range(0, len(level), 2 * _INTERNAL_K)]
        parts = parts or [[]]
        first = w.pos + (-w.pos) % 8
        nxt = []
        for k, part in enumerate(parts):
            left = _UNDEF if k == 0 else struct.pack("<Q", first + (k - 1) * tree_size)
            right = _UNDEF if k + 1 == len(parts) else struct.pack("<Q", first + (k + 1) * tree_size)
            body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", a, key) for a, key in part)
            node = b"TREE" + struct.pack("<BBH", 0, depth, len(part)) + left + right + body
            nxt.append((w.put(node + bytes(tree_size - len(node))), part[-1][1] if part else 0))
        if len(nxt) == 1:
            btree = nxt[0][0]
            break
        level, depth = nxt, depth + 1
    msgs = [(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))]
    for name in g.attrs.keys():
        msgs.append((_ATTRIBUTE, 0, _attribute_message(name, g.attrs[name], heap_ids, 8)))
    return w.put(_ohdr_v1(msgs)), btree, heap


def _write_dataset(w: _Writer, d: _NewDataset) -> int:
    nbytes = d.data.nbytes
    addr = w.put(memoryview(d.data).cast("B")) if nbytes else None
    layout = struct.pack("<BB", 3, 1) + (_UNDEF if addr is None else struct.pack("<Q", addr)) \
        + struct.pack("<Q", nbytes)
    msgs = [(_DATASPACE, 0, _enc_dataspace(d.data.shape)),
            (_DATATYPE, 1, _enc_datatype(d.data.dtype)),
            (_LAYOUT, 0, layout)]
    return w.put(_ohdr_v1(msgs))


def _strings(g: _NewGroup, out: list):
    for name in g.attrs.keys():
        v = g.attrs[name]
        if isinstance(v, str) and v:
            out.append(v)
    for child in g.children.values():
        if isinstance(child, _NewGroup):
            _strings(child, out)


def _write_file(path: str, root: _NewGroup):
    strings = []
    _strings(root, strings)
    with open(path, "wb") as fh:
        fh.write(bytes(_SB_SIZE))
        w = _Writer(fh, _SB_SIZE)
        heap_ids = {}
        if strings:
            blob, heap_ids = _gcol(strings, _SB_SIZE)
            w.put(blob)
        addr, btree, heap = _write_group(w, root, heap_ids)
        eof = w.pos
        sb = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
              + struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
              + struct.pack("<QQI4x", 0, addr, 1) + struct.pack("<QQ", btree, heap))
        fh.seek(0)
        fh.write(sb)


# -- r+: a changed group gets a new header -----------------------------------

def _commit(store: _Store, obj: _Object):
    if obj._link.site is None:
        raise UnsupportedFeature("changing the attributes of the root group (no link to "
                                 "repoint)")
    header = obj._header
    o = store.osize
    strings = [v for kind, v in obj.attrs._items.values() if kind == "new" and isinstance(v, str)
               and v]
    end = max(store.size, store.base + (store.eof or 0))
    end += (-end) % 8
    blob = b""
    heap_ids = {}
    if strings:
        if o != 8 or store.lsize != 8:
            raise UnsupportedFeature("writing strings in a file of 4-byte addresses")
        blob, heap_ids = _gcol(strings, end - store.base)
    attrs = []
    for name in obj.attrs.keys():
        kind, v = obj.attrs._items[name]
        attrs.append(v if kind == "raw" else _attribute_message(name, v, heap_ids, o))
    kept = [m for m in header.messages if m.mtype != _ATTRIBUTE]
    at = end - store.base + len(blob)
    if header.version == 1:
        msgs = []
        for m in kept:
            if m.mtype == _ATTR_INFO:
                raise UnsupportedFeature("dense attributes in a v1 object header")
            msgs.append((m.mtype, m.flags, m.data))
        new = _ohdr_v1(msgs + [(_ATTRIBUTE, 0, a) for a in attrs])
    else:
        msgs = []
        for m in kept:
            data = m.data
            if m.mtype == _ATTR_INFO:
                c = _Cursor(data, o, store.lsize, "attribute info message")
                c.skip(1)
                flags = c.uint(1)
                data = bytes([0, flags]) + (data[2:4] if flags & 0x01 else b"") + \
                    _UNDEF[:o] * (3 if flags & 0x02 else 2)
            msgs.append((m.mtype, m.flags, data, m.corder))
        new = _ohdr_v2(msgs + [(_ATTRIBUTE, 0, a, None) for a in attrs], header.flags,
                       header.times, header.phase)
    fh = store.fh
    fh.seek(end)
    fh.write(blob + new)
    fh.flush()
    os.fsync(fh.fileno())
    # repoint the parent's link, then fix the checksum of the block holding it
    link = obj._link
    _patch(store, store.base + link.site, at.to_bytes(o, "little"))
    if link.region is not None:
        start, size, c_at = link.region
        block = bytearray(store.read(start, size, "block holding a link"))
        if link.region_kind == "chunk":  # a header chunk: the checksum of what precedes it
            block[c_at:c_at + 4] = struct.pack("<I", lookup3(bytes(block[:c_at])))
        else:  # a heap block: the checksum of the block with the field zeroed
            block[c_at:c_at + 4] = bytes(4)
            block[c_at:c_at + 4] = struct.pack("<I", lookup3(bytes(block)))
        _patch(store, store.base + start, bytes(block))
    new_eof = end - store.base + len(blob) + len(new)
    _patch(store, store.eof_field, new_eof.to_bytes(o, "little"))
    if store.sb_version >= 2:
        head = os.pread(fh.fileno(), store.sb_end - 4 - store.sb_offset, store.sb_offset)
        _patch(store, store.sb_end - 4, struct.pack("<I", lookup3(head)))
    fh.flush()
    store.size = os.fstat(fh.fileno()).st_size
    store.eof = new_eof


def _patch(store: _Store, pos: int, data: bytes):
    """Write ``data`` at the file position ``pos``, visible to ``os.pread``."""
    store.fh.seek(pos)
    store.fh.write(data)
    store.fh.flush()


# -- the file ----------------------------------------------------------------

class File:
    """An HDF5 file: ``"r"`` reads, ``"r+"`` reads and changes attributes,
    ``"w"`` creates (truncates) a file written at :meth:`close`."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "r+", "w"):
            raise ValueError(f"mode must be 'r', 'r+' or 'w', got {mode!r}")
        self.path, self.mode = os.fspath(path), mode
        self._writable = mode != "r"
        self._dirty = {}
        self._store = None
        if mode == "w":
            self._root = _NewGroup()
            with open(self.path, "wb"):
                pass  # fail now, not at close, where the path cannot be written
        else:
            self._store = _Store(self.path, self._writable)
            self._objects = {}
            self._root = self._open(_Link(self._store.root, "hard"), "/")

    def _open(self, link: _Link, name: str):
        if link.kind != "hard":
            raise UnsupportedFeature(f"{link.kind} ({name!r})")
        obj = self._objects.get(link.addr)
        if obj is None:
            header = _Header(self._store, link.addr)
            types = {m.mtype for m in header.messages}
            if _LAYOUT in types:
                obj = Dataset(self, header, link)
            elif types & {_SYMBOL_TABLE, _LINK_INFO, _LINK, _GROUP_INFO}:
                obj = Group(self, header, link)
            elif _DATATYPE in types:
                raise UnsupportedFeature(f"committed datatype ({name!r})")
            else:
                raise HDF5Error(f"object {name!r} at {link.addr} is neither a group nor a dataset")
            self._objects[link.addr] = obj
        return obj

    # the root group's surface
    def keys(self):
        return self._root.keys()

    def __contains__(self, name):
        return name in self._root

    def __getitem__(self, name):
        return self._root[name]

    @property
    def attrs(self):
        return self._root.attrs

    def create_group(self, name: str):
        self._require_new()
        return self._root.create_group(name)

    def create_dataset(self, name: str, data):
        self._require_new()
        return self._root.create_dataset(name, data)

    def _require_new(self):
        if self.mode != "w":
            raise UnsupportedFeature("creating objects in an existing file")

    def close(self):
        if self.mode == "w":
            root, self._root = self._root, None
            if root is not None:
                _write_file(self.path, root)
            return
        store, self._store = self._store, None
        if store is None:
            return
        try:
            for obj in self._dirty.values():
                _commit(store, obj)
        finally:
            store.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self.mode == "w":
            self._root = None  # leave the truncated file; write nothing half made
        self.close()
