"""The port's own HDF5 reader and writer for dotTHz files.

Built on numpy, ``zlib``, the standard library and the package's own LZF
codec, so that opening, saving and updating a scan needs no HDF5 library.
The surface is the part of h5py's that the port uses: :class:`File` as a
context manager; groups with ``keys()`` (ascending byte order of the
names, as h5py lists them), ``[name]``, ``in`` and ``attrs``; datasets
with ``shape``, ``ndim``, ``size``, ``maxshape``, ``dtype``, ``chunks``,
``[()]``, basic slices and ``read_direct_chunk``; :func:`is_group` /
:func:`is_dataset` in place of ``isinstance(obj, h5py.Group)``.

Reading covers what h5py writes for the dotTHz layout with either
``libver``, in SWMR mode too:

* superblocks v0-v3; object headers v1 (8-byte-aligned messages,
  continuation blocks) and v2 (``OHDR``/``OCHK``, lookup3 checksums);
* symbol-table groups (v1 B-tree of any depth, ``SNOD``, local heap) and
  link-message groups, compact or dense (fractal heap + v2 B-tree);
* compact and dense attributes: a fractal heap with direct and indirect
  blocks (checksummed direct blocks too) and a v2 B-tree of any depth;
* fixed- and floating-point types of either byte order, fixed-length
  strings, variable-length strings in a global heap (``GCOL``: ``str`` in
  attributes, ``bytes`` in datasets, as h5py reads them), enums (h5py's
  boolean enum as numpy ``bool``, any other as its integer base),
  compounds (nested, their offsets and itemsize kept; two float members
  ``r``, ``i`` as complex) and array types (numpy subarrays);
* scalar and simple dataspaces, with their maximum shapes;
* compact, contiguous and chunked layouts, the chunks indexed by a v1
  B-tree, a single-chunk index, an implicit index, a fixed array (paged or
  not), an extensible array (index block, super blocks, paged data blocks)
  or a v2 B-tree; chunks never written read as the fill value;
* the deflate, shuffle, fletcher32 (checksum checked) and lzf filters (lzf
  in host C, ``csrc/lzf.c`` through :mod:`.lzf`), a chunk an optional filter
  skipped (its filter mask bit set) read as stored.

A contiguous dataset is read through ``np.memmap`` at its offset, so a
slice reads only its bytes; a chunked one decodes only the chunks that a
slice touches and crops the edge chunks. As in h5py, every dataset is
listed and opened with its shape; what this module cannot read raises
:class:`UnsupportedFeature` naming the HDF5 feature only when the data (or
``dtype``) are read: the szip, n-bit and scale-offset filters, external
storage, virtual datasets, unfiltered partial edge chunks, null
dataspaces, reference, opaque, bitfield and time types, variable-length
sequences, committed datatypes, shared messages and huge or filtered
fractal-heap objects. A damaged file raises :class:`HDF5Error` (a bad
signature or checksum, a truncated structure, an lzf stream that does not
decode to its chunk), never a wrong array.

Writing (mode ``"w"``) makes what the port's callers create: superblock
v0, symbol-table groups, datasets (integer and IEEE float types of either
byte order) and attributes, a ``str`` as a variable-length UTF-8 string as
h5py stores one, numbers as numeric scalars or arrays, ``np.bytes_`` as a
fixed-length string. A dataset is contiguous unless ``create_dataset`` is
given h5py's ``chunks`` (with ``compression`` "gzip" or "lzf",
``compression_opts``, ``shuffle``): then its chunks are indexed by a v1
B-tree of 2K = 64 entries a node, as many levels as they need, behind a
filter pipeline message v1, as h5py writes them under its default
``libver``. h5py reads the result; the default format was chosen because
every HDF5 library since 1.8 reads it and it needs no metadata checksums.

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

from thz_image_explorer_tpu_torch.io import lzf

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_M32 = 0xFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x07, 0x08, 0x0A, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0x10, 0x11, 0x15

_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "n-bit",
                 6: "scale-offset", 32000: "lzf"}
_READ_FILTERS = (1, 2, 3, 32000)
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
    """A datatype as the reader sees it. ``dtype`` is the numpy dtype of the
    stored elements (a compound's offsets and itemsize kept, an array type a
    subarray dtype). ``kind`` "num" reads as ``dtype``; "bool" (h5py's
    boolean enum) as numpy ``bool``; "vstr" (a variable-length string,
    ``size`` bytes per element on disk: length, heap collection, index) as
    ``str`` in attributes and ``bytes`` in datasets, as h5py reads them."""

    __slots__ = ("kind", "dtype", "size")

    def __init__(self, kind, dtype, size):
        self.kind, self.dtype, self.size = kind, dtype, size

    @property
    def result(self) -> np.dtype:
        """The dtype h5py gives the elements."""
        return {"num": self.dtype, "bool": np.dtype(bool), "vstr": np.dtype(object)}[self.kind]


def _member_name(c: _Cursor, padded: bool) -> str:
    end = c.data.index(b"\x00", c.pos)
    raw = c.take(end - c.pos + 1)
    if padded:
        c.skip((-len(raw)) % 8)
    return raw[:-1].decode("utf-8")


def _datatype(c: _Cursor) -> _Type:
    b0 = c.uint(1)
    cls, version = b0 & 0x0F, b0 >> 4
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
        return _Type("num", np.dtype(f"S{size}"), size)
    if cls == 6:
        return _compound(c, version, bits & 0xFFFF, size)
    if cls == 8:
        base = _datatype(c)
        if base.kind != "num" or base.dtype.kind not in "iu":
            raise UnsupportedFeature("enum datatype of a non-integer base")
        n = bits & 0xFFFF
        names = [_member_name(c, version < 3) for _ in range(n)]
        values = np.frombuffer(c.take(n * base.size), base.dtype).tolist()
        if dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
            return _Type("bool", base.dtype, base.size)
        return base
    if cls == 9:
        if bits & 0x0F != 1:
            raise UnsupportedFeature("variable-length sequence type")
        _datatype(c)  # the base type (characters); ASCII and UTF-8 both read as UTF-8
        return _Type("vstr", np.dtype(f"V{size}"), size)
    if cls == 10:
        ndims = c.uint(1)
        if version < 3:
            c.skip(3)
        dims = tuple(c.uint(4) for _ in range(ndims))
        if version < 3:
            c.skip(4 * ndims)  # permutation indices (unused by the library)
        base = _datatype(c)
        return _Type("num", np.dtype((_nested_dtype(base, "array"), dims)), size)
    raise UnsupportedFeature(f"{_TYPE_CLASS_NAMES.get(cls, f'class {cls}')} datatype")


def _nested_dtype(t: _Type, where: str) -> np.dtype:
    """A member's or element's numpy dtype inside a compound or array type."""
    if t.kind == "vstr":
        raise UnsupportedFeature(f"variable-length string inside an {where} datatype")
    if t.kind == "bool" and t.size != 1:
        raise UnsupportedFeature(f"boolean enum of {t.size} bytes inside an {where} datatype")
    return t.result


def _compound(c: _Cursor, version: int, n: int, size: int) -> _Type:
    """A compound type as h5py maps it: its members at their offsets with the
    type's itemsize, or a complex dtype for two float members named r and i."""
    names, formats, offsets = [], [], []
    for _ in range(n):
        names.append(_member_name(c, version < 3))
        if version < 3:
            offsets.append(c.uint(4))
        else:
            offsets.append(c.uint(_limit_enc_size(size)))
        dims = ()
        if version == 1:
            rank = c.uint(1)
            c.skip(3 + 4 + 4)  # reserved, permutation, reserved
            dims = tuple(c.uint(4) for _ in range(4))[:rank]
        member = _nested_dtype(_datatype(c), "compound")
        formats.append(np.dtype((member, dims)) if dims else member)
    if names == ["r", "i"] and formats[0] == formats[1] and formats[0].kind == "f":
        width = formats[0].itemsize
        if offsets != [0, width] or size != 2 * width:
            raise UnsupportedFeature("complex compound datatype with padding")
        return _Type("num", np.dtype(f"c{size}").newbyteorder(formats[0].byteorder), size)
    try:
        dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                          "itemsize": size})
    except ValueError as e:
        raise HDF5Error(f"bad compound datatype: {e}") from None
    return _Type("num", dtype, size)


def _dataspace(c: _Cursor) -> tuple:
    """(shape, maximum shape): an unlimited maximum is None; a null
    dataspace has the shape None."""
    version, rank = c.uint(1), c.uint(1)
    flags = c.uint(1)
    if version == 1:
        c.skip(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = c.uint(1)
    else:
        raise UnsupportedFeature(f"dataspace version {version}")
    if kind == 2:
        return None, None
    shape = tuple(c.length() for _ in range(rank))
    if not flags & 0x01:
        return shape, shape
    unlimited = (1 << (8 * c.lsize)) - 1
    return shape, tuple(None if m == unlimited else m for m in (c.length() for _ in range(rank)))


def _elements(raw: bytes, t: _Type, shape: tuple) -> np.ndarray:
    """Stored elements as an array of ``t.dtype`` (a subarray dtype adds its
    dimensions at the end)."""
    n = int(np.prod(shape, dtype=np.int64))
    if len(raw) < n * t.size:
        raise HDF5Error(f"truncated data: {len(raw)} bytes for {n} elements of {t.size}")
    return np.frombuffer(raw, t.dtype, n).reshape(tuple(shape) + t.dtype.shape)


def _finish(store: _Store, t: _Type, arr: np.ndarray, text: bool):
    """Stored elements as h5py returns them: a variable-length string as
    ``str`` (``text``, attributes) or ``bytes`` (datasets), a boolean enum as
    ``bool``; a 0-d result as its scalar."""
    if t.kind == "vstr":
        out = np.empty(arr.shape, object)
        flat = out.reshape(-1)
        for i, ref in enumerate(arr.reshape(-1).tolist()):
            length = int.from_bytes(ref[:4], "little")
            coll = int.from_bytes(ref[4:4 + store.osize], "little")
            if length == 0 or coll in (0, (1 << (8 * store.osize)) - 1):
                value = b""
            else:
                index = int.from_bytes(ref[4 + store.osize:8 + store.osize], "little")
                value = store.gheap_object(coll, index)[:length]
            flat[i] = value.decode("utf-8") if text else value
        arr = out
    elif t.kind == "bool":
        arr = arr != 0
    return arr[()] if arr.ndim == 0 else arr


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
    shape = _dataspace(sc)[0]
    if shape is None:
        raise UnsupportedFeature("null dataspace")
    return name, _finish(store, t, _elements(data[c.pos:], t, shape).copy(), text=True)


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
    """(record type, every record of a v2 B-tree in key order)."""
    where = f"v2 B-tree at {addr}"
    c = store.cursor_at_most(addr, 64, where)
    c.sig(b"BTHD")
    if c.uint(1) != 0:
        raise UnsupportedFeature("v2 B-tree version")
    rtype = c.uint(1)
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
    return rtype, out


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
                    for rec in _btree2_records(store, name_tree)[1]:
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
                        for rec in _btree2_records(store, name_tree)[1]:
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
    """A dataset of an open file: ``shape``, ``ndim``, ``size``,
    ``maxshape`` and ``dtype``, and reads through ``[...]``.

    As in h5py, a dataset is listed and opened with its shape whatever its
    storage: what this module cannot read (a layout, a chunk index, a
    filter, external storage, a type) raises :class:`UnsupportedFeature`,
    naming it, only when the data are read (and from ``dtype`` for a type
    it cannot map)."""

    def __init__(self, file, header, link):
        super().__init__(file, header, link)
        store = file._store
        self._where = f"dataset at {header.addr}"
        m = header.one(_DATASPACE)
        if m is None:
            raise HDF5Error(f"no dataspace message in {self._where}")
        self.shape, self.maxshape = _dataspace(_Cursor(m.data, store.osize, store.lsize,
                                                       self._where))
        self.ndim = 0 if self.shape is None else len(self.shape)
        self.size = 0 if self.shape is None else int(np.prod(self.shape, dtype=np.int64))
        self._t = None
        self._kind = None  # the storage, once _prepare has read it

    @property
    def dtype(self) -> np.dtype:
        return self._type().result

    @property
    def chunks(self):
        """The chunk shape of a chunked dataset, else None."""
        self._prepare()
        return self._chunks

    def _type(self) -> _Type:
        if self._t is None:
            m = self._header.one(_DATATYPE)
            if m is None:
                raise HDF5Error(f"no datatype message in {self._where}")
            store = self.file._store
            self._t = _datatype(_Cursor(m.data, store.osize, store.lsize, self._where))
        return self._t

    def _prepare(self):
        """Read what a read needs, once."""
        if self._kind is not None:
            return
        header = self._header
        if self.shape is None:
            raise UnsupportedFeature("null dataspace")
        if header.find(_EXTERNAL):
            raise UnsupportedFeature("external data storage")
        t = self._type()
        self._fill = _fill_raw(header, t)
        self._filters = _filters(header)
        self._kind = self._layout(header.one(_LAYOUT), t)

    def _layout(self, m, t: _Type) -> str:
        store, where = self.file._store, self._where
        if m is None:
            raise HDF5Error(f"no layout message in {where}")
        c = _Cursor(m.data, store.osize, store.lsize, where)
        version = c.uint(1)
        self._chunks = None
        if version in (1, 2):
            rank, cls = c.uint(1), c.uint(1)
            c.skip(5)
            addr = c.addr() if cls != 0 else None
            dims = [c.uint(4) for _ in range(rank)]
            if cls == 2:
                return self._chunk_layout(dims, "btree1", addr, t)
            if cls == 1:
                kind, self._addr = "contiguous", addr
            else:
                kind, self._data = "compact", c.take(c.uint(4))
        elif version not in (3, 4):
            raise UnsupportedFeature(f"data layout version {version}")
        else:
            cls = c.uint(1)
            if cls == 0:
                kind, self._data = "compact", c.take(c.uint(2))
            elif cls == 1:
                kind, self._addr = "contiguous", c.addr()
                c.length()
            elif cls == 2 and version == 3:
                rank = c.uint(1)
                addr = c.addr()
                return self._chunk_layout([c.uint(4) for _ in range(rank)], "btree1", addr, t)
            elif cls == 2:
                flags, rank, enc = c.uint(1), c.uint(1), c.uint(1)
                dims = [c.uint(enc) for _ in range(rank)]
                index = c.uint(1)
                if flags & 0x01:
                    raise UnsupportedFeature("unfiltered partial edge chunks")
                if index not in _CHUNK_INDEX:
                    raise UnsupportedFeature(f"chunk index type {index}")
                name, n_params = _CHUNK_INDEX[index]
                filtered = (c.length(), c.uint(4)) if index == 1 and flags & 0x02 else None
                c.skip(n_params)  # the index's own header repeats them
                return self._chunk_layout(dims, name, c.addr(), t, filtered)
            elif cls == 3:
                raise UnsupportedFeature("virtual dataset layout")
            else:
                raise HDF5Error(f"unknown layout class {cls} in {where}")
        if kind == "contiguous" and self._addr is not None:
            end = self._addr + self.size * t.size
            if store.base + end > store.size:
                raise HDF5Error(f"truncated file: the data of {where} ends at {end}, "
                                f"the file at {store.size}")
        if kind == "compact" and len(self._data) < self.size * t.size:
            raise HDF5Error(f"truncated compact data in {where}")
        return kind

    def _chunk_layout(self, dims, index, addr, t: _Type, filtered=None) -> str:
        if len(dims) != self.ndim + 1 or dims[-1] != t.size or 0 in dims:
            raise HDF5Error(f"chunk dimensions {dims} do not fit {self._where} "
                            f"({self.ndim} dimensions of {t.size}-byte elements)")
        self._index, self._addr, self._single = index, addr, filtered
        self._chunks = tuple(dims[:-1])
        self._chunk_map = None
        return "chunked"

    def _filled(self, shape) -> np.ndarray:
        out = np.empty(shape, self._t.dtype)
        out[...] = np.frombuffer(self._fill, self._t.dtype, 1)[0]
        return out

    def __getitem__(self, key):
        self._prepare()
        t, store = self._t, self.file._store
        sel = _selection(key, self.shape)
        if self._kind == "compact":
            arr = _elements(self._data, t, self.shape)[_np_key(sel)].copy()
        elif self._kind == "chunked":
            arr = self._read_chunked(sel)
        elif self._addr is None or self.size == 0:
            arr = self._filled(tuple(len(range(*s)) for s in sel if not isinstance(s, int)))
        elif t.dtype.shape:  # a subarray type: its bytes, then its elements
            mm = np.memmap(store.fh, np.uint8, "r", store.base + self._addr,
                           self.shape + (t.size,))
            try:
                part = np.array(mm[_np_key(sel)])
            finally:
                del mm
            arr = _elements(part.tobytes(), t, part.shape[:-1]).copy()
        else:
            mm = np.memmap(store.fh, t.dtype, "r", store.base + self._addr, self.shape)
            try:
                arr = np.array(mm[_np_key(sel)])
            finally:
                del mm
        return _finish(store, t, arr, text=False)

    def read_direct_chunk(self, offsets) -> tuple[int, bytes]:
        """(filter mask, stored bytes) of the chunk whose first element is
        at ``offsets``, no filter undone: h5py's ``id.read_direct_chunk``."""
        self._prepare()
        if self._kind != "chunked":
            raise ValueError(f"{self._where} is not chunked")
        if self._chunk_map is None:
            self._chunk_map = self._chunk_addresses()
        entry = self._chunk_map.get(tuple(int(o) for o in offsets))
        if entry is None:
            raise KeyError(f"no chunk stored at {tuple(offsets)} in {self._where}")
        addr, size, mask = entry
        return mask, self.file._store.read(addr, size, f"chunk at {addr}")

    # chunked reads
    def _chunk_addresses(self):
        """{chunk origin (element offsets): (address, stored size, filter mask)}."""
        store = self.file._store
        nbytes = int(np.prod(self._chunks)) * self._t.size
        if self._addr is None:
            return {}
        if self._index == "single":
            size, mask = self._single if self._single else (nbytes, 0)
            return {(0,) * self.ndim: (self._addr, size, mask)}
        if self._index == "btree1":
            return _btree1_chunks(store, self._addr, self.ndim)
        if self._index == "btree2":
            return _btree2_chunks(store, self._addr, self._chunks, nbytes)
        # the array indices number the chunks in row-major order over the
        # chunk counts of the maximum shape; the extensible array first moves
        # its one unlimited dimension to the front (H5Dearray.c's swizzle)
        counts = [None if m is None else -(-m // c) for m, c in zip(self.maxshape, self._chunks)]
        order = list(range(self.ndim))
        if None in counts:
            unlimited = counts.index(None)
            order = [unlimited] + order[:unlimited] + order[unlimited + 1:]
        if None in [counts[d] for d in order[1:]] or (self._index != "earray" and None in counts):
            raise HDF5Error(f"a {self._index} chunk index over {counts} chunks in {self._where}")
        if self._index == "implicit":
            n = int(np.prod(counts, dtype=np.int64))
            addr = self._addr + nbytes * np.arange(n, dtype=np.uint64)
            return _chunk_dict(np.arange(n), (addr, nbytes, 0), store.osize, self._chunks,
                               counts, order)
        if self._index == "farray":
            idx, entries = _farray_entries(store, self._addr, nbytes)
        else:
            idx, entries = _earray_entries(store, self._addr, nbytes)
        return _chunk_dict(idx, entries, store.osize, self._chunks, counts, order)

    def _read_chunked(self, sel):
        store, t = self.file._store, self._t
        if self._chunk_map is None:
            self._chunk_map = self._chunk_addresses()
        ranges = [range(s, s + 1) if isinstance(s, int) else range(*s) for s in sel]
        out = np.empty([len(r) for r in ranges], t.dtype)
        fill = np.frombuffer(self._fill, t.dtype, 1)[0]
        nbytes = int(np.prod(self._chunks)) * t.size
        if out.size:
            per_dim = [range(r[0] // c, r[-1] // c + 1) for r, c in zip(ranges, self._chunks)]
            for grid in np.ndindex(*[len(p) for p in per_dim]):
                origin = tuple(p[g] * c for p, g, c in zip(per_dim, grid, self._chunks))
                src, dst = [], []
                for r, o, c in zip(ranges, origin, self._chunks):
                    # the selected positions k with o <= r[k] < o + c
                    k0 = max(0, -(-(o - r.start) // r.step))
                    k1 = min(len(r), -(-(o + c - r.start) // r.step))
                    src.append(slice(r[k0] - o, r[k1 - 1] - o + 1, r.step) if k0 < k1 else None)
                    dst.append(slice(k0, k1))
                if None in src:
                    continue  # a step that jumps over this chunk
                entry = self._chunk_map.get(origin)
                if entry is None:
                    out[tuple(dst)] = fill
                    continue
                addr, size, mask = entry
                raw = _decode_chunk(store.read(addr, size, f"chunk at {addr}"), self._filters,
                                    mask, nbytes, addr)
                out[tuple(dst)] = _elements(raw, t, self._chunks)[tuple(src)]
        keep = tuple(len(r) for r, s in zip(ranges, sel) if not isinstance(s, int))
        return out.reshape(keep + t.dtype.shape)


#: chunk index types of a layout message v4: (name, bytes of parameters
#: before the index address)
_CHUNK_INDEX = {1: ("single", 0), 2: ("implicit", 0), 3: ("farray", 1), 4: ("earray", 5),
                5: ("btree2", 6)}


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


def _fill_raw(header: _Header, t: _Type) -> bytes:
    """One element of the fill value as stored (zeros where none is set)."""
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
    if not store_raw or t.kind == "vstr":
        return bytes(t.size)
    if len(store_raw) != t.size:
        raise HDF5Error(f"a fill value of {len(store_raw)} bytes for elements of {t.size}")
    return store_raw


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
        if fid not in _READ_FILTERS:
            raise UnsupportedFeature(f"filter {_FILTER_NAMES.get(fid, 'id')} (id {fid})")
        out.append((fid, values))
    return out


def _decode_chunk(raw: bytes, filters, mask: int, nbytes: int, addr: int) -> bytes:
    # the size each filter was given when the chunk was written, where no
    # compressor ran before it
    sizes, size = [], nbytes
    for i, (fid, _) in enumerate(filters):
        sizes.append(size)
        if size is not None and not mask & (1 << i):
            size = size + 4 if fid == 3 else size if fid == 2 else None
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
            width = values[0] if values else 1
            n = len(raw) // width
            planes = np.frombuffer(raw, np.uint8, n * width).reshape(width, n)
            out = np.empty((n, width), np.uint8)
            for k in range(width):  # one byte plane at a time: faster than a transpose
                out[:, k] = planes[k]
            raw = out.tobytes() + raw[n * width:]
        elif fid == 3:
            if len(raw) < 4:
                raise HDF5Error(f"truncated fletcher32 chunk at {addr}")
            stored = int.from_bytes(raw[-4:], "little")
            raw = raw[:-4]
            got = fletcher32(raw)
            if stored != got and stored != int.from_bytes(got.to_bytes(4, "little"), "big"):
                raise HDF5Error(f"fletcher32 checksum mismatch in the chunk at {addr}")
        else:
            if sizes[i] is None:
                raise UnsupportedFeature("lzf after another compressing filter")
            try:
                raw = lzf.decompress(raw, sizes[i])
            except ValueError as e:
                raise HDF5Error(f"lzf failed on the chunk at {addr}: {e}") from None
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


def _le(rows: np.ndarray, start: int, width: int) -> np.ndarray:
    """The little-endian unsigned field at bytes [start, start + width) of
    each row of a (n, record size) byte array."""
    out = np.zeros(len(rows), np.uint64)
    for k in range(width):
        out |= rows[:, start + k].astype(np.uint64) << np.uint64(8 * k)
    return out


def _index_entries(raw: bytes, n: int, esize: int, osize: int, filtered: bool, nbytes: int):
    """(addresses, stored sizes, filter masks) of ``n`` elements of a fixed
    or extensible array: an address, or for filtered chunks an address, a
    size (of the bytes left) and a mask."""
    rows = np.frombuffer(raw, np.uint8, n * esize).reshape(n, esize)
    if not filtered:
        if esize != osize:
            raise HDF5Error(f"{esize}-byte elements in a chunk index of {osize}-byte addresses")
        return _le(rows, 0, osize), nbytes, 0
    if esize <= osize + 4:
        raise HDF5Error(f"{esize}-byte elements in a filtered chunk index")
    return _le(rows, 0, osize), _le(rows, osize, esize - osize - 4), _le(rows, esize - 4, 4)


def _chunk_dict(idx, entries, osize: int, chunks, counts, order) -> dict:
    """{origin: (address, size, mask)} of the chunks at the linear indices
    ``idx``, numbered in row-major order of the dimensions ``order``
    (slowest first) over ``counts`` chunks a dimension (the slowest one's
    count unused); undefined addresses (chunks never written) left out."""
    idx = np.asarray(idx, np.int64)
    addr, size, mask = (np.broadcast_to(np.asarray(e, np.uint64), idx.shape) for e in entries)
    keep = addr != np.uint64((1 << (8 * osize)) - 1)
    rest = idx[keep]
    coords = [None] * len(chunks)
    for d in reversed(order[1:]):
        rest, coords[d] = np.divmod(rest, counts[d])
    coords[order[0]] = rest
    origins = zip(*[(coords[d] * chunks[d]).tolist() for d in range(len(chunks))])
    return dict(zip(origins, zip(addr[keep].tolist(), size[keep].tolist(), mask[keep].tolist())))


def _farray_entries(store: _Store, addr: int, nbytes: int):
    """(indices, entries) of a fixed array's elements."""
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
        return np.arange(0), (np.zeros(0, np.uint64), 0, 0)
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
    return np.arange(n), _index_entries(raw, n, esize, store.osize, client == 1, nbytes)


def _earray_entries(store: _Store, addr: int, nbytes: int):
    """(indices, entries) of an extensible array's elements (``H5EA*.c``):
    the index block's own elements, then super block ``u``'s
    2**(u // 2) data blocks of 2**((u + 1) // 2) * (minimum) elements; the
    first super blocks' data blocks are addressed from the index block,
    the others' from their super block, and a data block over 2**page_bits
    elements is paged (its super block's bitmap says which pages exist)."""
    o = store.osize
    where = f"extensible array at {addr}"
    c = store.cursor_at_most(addr, 12 + 6 * store.lsize + o + 4, where)
    c.sig(b"EAHD")
    if c.uint(1) != 0:
        raise UnsupportedFeature("extensible array version")
    client, esize, max_bits, iblock_n, dblock_min, sblock_min, page_bits = (
        c.uint(1) for _ in range(7))
    for _ in range(4):
        c.length()  # super blocks, their bytes, data blocks, their bytes
    n = c.length()  # the highest index set, plus one
    c.length()  # elements realized
    iblock = c.addr()
    _check(c.data[:c.pos + 4], where)
    for v, name in ((dblock_min, "data block minimum"), (sblock_min, "super block minimum")):
        if v < 1 or v & (v - 1):
            raise HDF5Error(f"{where}: its {name} {v} is not a power of 2")
    if max_bits < _log2(dblock_min):
        raise HDF5Error(f"{where}: {max_bits} index bits under its data block minimum")
    idx, raws = [], []
    if iblock is None or n == 0:
        return np.arange(0), (np.zeros(0, np.uint64), 0, 0)
    n_sblocks = 1 + max_bits - _log2(dblock_min)
    in_iblock = 2 * _log2(sblock_min)  # super blocks whose data blocks the index block addresses
    n_daddr, n_saddr = 2 * (sblock_min - 1), max(n_sblocks - in_iblock, 0)
    off_size = (max_bits + 7) // 8
    page_n = 1 << page_bits
    w = f"extensible array index block at {iblock}"
    block = store.read(iblock, 6 + o + iblock_n * esize + (n_daddr + n_saddr) * o + 4, w)
    if block[:4] != b"EAIB":
        raise HDF5Error(f"bad signature in {w}")
    _check(block, w)
    c = _Cursor(block, o, store.lsize, w, 4)
    if c.uint(1) != 0 or c.uint(1) != client or c.addr() != addr:
        raise HDF5Error(f"{w} does not belong to {where}")
    idx.append(np.arange(min(iblock_n, n)))
    raws.append(c.take(iblock_n * esize)[:len(idx[-1]) * esize])
    daddrs = [c.addr() for _ in range(n_daddr)]
    saddrs = [c.addr() for _ in range(n_saddr)]

    def block_head(data, sig, at, kind):
        cc = _Cursor(data, o, store.lsize, kind, 0)
        cc.sig(sig)
        if cc.uint(1) != 0 or cc.uint(1) != client or cc.addr() != addr:
            raise HDF5Error(f"{kind} at {at} does not belong to {where}")
        cc.skip(off_size)  # the block's first element (informational)
        return cc

    first = dblock_start = 0  # the super block's first element (after the index block's)
    for u in range(n_sblocks):
        n_dblocks, dn = 1 << (u // 2), dblock_min << ((u + 1) // 2)
        start = first
        first += n_dblocks * dn
        if iblock_n + start >= n:
            break
        n_pages = dn // page_n if dn > page_n else 0
        bitmap = None
        if u < in_iblock:
            dblocks = daddrs[dblock_start:dblock_start + n_dblocks]
            if n_pages:
                raise UnsupportedFeature("paged data blocks in an extensible array's index block")
        else:
            sa = saddrs[u - in_iblock]
            if sa is None:
                continue
            per_block = (n_pages + 7) // 8
            w = f"extensible array super block at {sa}"
            data = store.read(sa, 6 + o + off_size + n_dblocks * (per_block + o) + 4, w)
            _check(data, w)
            cc = block_head(data, b"EASB", sa, "extensible array super block")
            bitmap = cc.take(n_dblocks * per_block)
            dblocks = [cc.addr() for _ in range(n_dblocks)]
        dblock_start += n_dblocks
        for k, da in enumerate(dblocks):
            f0 = iblock_n + start + k * dn
            if f0 >= n:
                break
            if da is None:
                continue
            prefix = 6 + o + off_size
            w = f"extensible array data block at {da}"
            if not n_pages:
                count = min(dn, n - f0)
                data = store.read(da, prefix + dn * esize + 4, w)
                _check(data, w)
                block_head(data, b"EADB", da, "extensible array data block")
                idx.append(np.arange(f0, f0 + count))
                raws.append(data[prefix:prefix + count * esize])
                continue
            head = store.read(da, prefix + 4, w)
            _check(head, w)
            block_head(head, b"EADB", da, "extensible array data block")
            for p in range(n_pages):
                p0 = f0 + p * page_n
                if p0 >= n:
                    break
                bit = k * n_pages + p
                if not bitmap[bit // 8] & (0x80 >> (bit % 8)):
                    continue  # page never written: no chunk
                at = da + prefix + 4 + p * (page_n * esize + 4)
                page = store.read(at, page_n * esize + 4, f"extensible array page at {at}")
                _check(page, f"extensible array page at {at}")
                count = min(page_n, n - p0)
                idx.append(np.arange(p0, p0 + count))
                raws.append(page[:count * esize])
    idx = np.concatenate(idx)
    return idx, _index_entries(b"".join(raws), len(idx), esize, o, client == 1, nbytes)


def _btree2_chunks(store: _Store, addr: int, chunks, nbytes: int) -> dict:
    """A v2 B-tree chunk index: records of type 10 (an address) or 11 (an
    address, a size and a filter mask), each ending in its chunk's scaled
    offsets (chunk indices, 8 bytes a dimension)."""
    rtype, records = _btree2_records(store, addr)
    if rtype not in (10, 11):
        raise HDF5Error(f"v2 B-tree at {addr} has records of type {rtype}, not chunks")
    if not records:
        return {}
    o, ndim, rsize = store.osize, len(chunks), len(records[0])
    rows = np.frombuffer(b"".join(records), np.uint8).reshape(len(records), rsize)
    width = rsize - o - 8 * ndim - (4 if rtype == 11 else 0)
    if (rtype == 10 and width != 0) or (rtype == 11 and width < 1):
        raise HDF5Error(f"{rsize}-byte chunk records in the v2 B-tree at {addr}")
    entries = (_le(rows, 0, o), nbytes, 0) if rtype == 10 else \
        (_le(rows, 0, o), _le(rows, o, width), _le(rows, o + width, 4))
    scaled = [_le(rows, rsize - 8 * (ndim - d), 8) for d in range(ndim)]
    addr_, size, mask = (np.broadcast_to(np.asarray(e, np.uint64), len(records)) for e in entries)
    keep = addr_ != np.uint64((1 << (8 * o)) - 1)
    origins = zip(*[(scaled[d][keep] * np.uint64(chunks[d])).tolist() for d in range(ndim)])
    return dict(zip(origins, zip(addr_[keep].tolist(), size[keep].tolist(), mask[keep].tolist())))


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
    """A dataset to write: contiguous, or chunked with h5py's filters
    (shuffle, then deflate or lzf, all optional as h5py sets them)."""

    def __init__(self, data, chunks=None, compression=None, compression_opts=None,
                 shuffle=False):
        self.data = np.asarray(data, order="C")  # a 0-d array stays 0-d
        _enc_datatype(self.data.dtype)  # refuse a type it cannot write now
        self.chunks = None if chunks is None else tuple(int(c) for c in chunks)
        self.filters = []  # (id, name, client data), in the order applied
        if shuffle:
            self.filters.append((2, "shuffle", [self.data.dtype.itemsize]))
        if compression == "gzip":
            level = 4 if compression_opts is None else int(compression_opts)
            if not 0 <= level <= 9:
                raise ValueError(f"gzip level {level} is not in 0-9")
            self.filters.append((1, "deflate", [level]))
        elif compression == "lzf":
            if compression_opts is not None:
                raise ValueError("lzf takes no compression_opts")
        elif compression is not None:
            raise UnsupportedFeature(f"writing the {compression!r} filter")
        if self.chunks is None:
            if self.filters or compression:
                raise ValueError("a filtered dataset needs chunks")
            return
        if len(self.chunks) != self.data.ndim or self.data.ndim == 0 or min(self.chunks) < 1:
            raise ValueError(f"chunks {self.chunks} for data of shape {self.data.shape}")
        if compression == "lzf":  # h5py's client data: its filter's and LZF's versions
            chunk_bytes = int(np.prod(self.chunks)) * self.data.dtype.itemsize
            self.filters.append((32000, "lzf", [4, 0x0105, chunk_bytes]))


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

    def create_dataset(self, name: str, data, chunks=None, compression=None,
                       compression_opts=None, shuffle=False) -> _NewDataset:
        """h5py's keywords: ``chunks`` (a tuple), ``compression`` ("gzip",
        level ``compression_opts``, default 4; or "lzf") and ``shuffle``."""
        if name in self.children:
            raise ValueError(f"name {name!r} already exists")
        d = self.children[name] = _NewDataset(data, chunks, compression, compression_opts,
                                              shuffle)
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
    msgs = [(_DATASPACE, 0, _enc_dataspace(d.data.shape)),
            (_DATATYPE, 1, _enc_datatype(d.data.dtype))]
    if d.chunks is None:
        nbytes = d.data.nbytes
        addr = w.put(memoryview(d.data).cast("B")) if nbytes else None
        msgs.append((_LAYOUT, 0, struct.pack("<BB", 3, 1) + _enc_addr(addr)
                     + struct.pack("<Q", nbytes)))
        return w.put(_ohdr_v1(msgs))
    btree = _write_chunks(w, d)
    msgs.append((_LAYOUT, 0, struct.pack("<BBB", 3, 2, d.data.ndim + 1) + _enc_addr(btree)
                 + struct.pack(f"<{d.data.ndim + 1}I", *d.chunks, d.data.dtype.itemsize)))
    if d.filters:
        msgs.append((_FILTERS, 0, _enc_filters(d.filters)))
    return w.put(_ohdr_v1(msgs))


def _enc_addr(addr) -> bytes:
    return _UNDEF if addr is None else struct.pack("<Q", addr)


def _enc_filters(filters) -> bytes:
    """A filter pipeline message v1, every filter optional (as h5py sets
    them: a chunk lzf does not shrink is stored as it is)."""
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, name, values in filters:
        bname = _pad8(name.encode() + b"\x00")
        out += struct.pack("<HHHH", fid, len(bname), 1, len(values)) + bname + struct.pack(
            f"<{len(values)}I", *values) + bytes(4 * (len(values) % 2))
    return out


def _encode_chunk(raw: bytes, filters) -> tuple[bytes, int]:
    """A chunk through the filters: (stored bytes, filter mask)."""
    mask = 0
    for i, (fid, _, values) in enumerate(filters):
        if fid == 2:
            rows = np.frombuffer(raw, np.uint8).reshape(-1, values[0])
            planes = np.empty(rows.shape[::-1], np.uint8)
            for k in range(values[0]):
                planes[k] = rows[:, k]
            raw = planes.tobytes()
        elif fid == 1:
            raw = zlib.compress(raw, values[0])
        else:
            packed = lzf.compress(raw)
            if packed is None:
                mask |= 1 << i
            else:
                raw = packed
    return raw, mask


#: the chunk B-tree's K in a superblock v0 file (HDF5's default): up to 2K
#: entries a node
_CHUNK_K = 32


def _write_chunks(w: _Writer, d: _NewDataset):
    """Every chunk (edge chunks padded with zeros) in row-major order, then
    the v1 B-tree indexing them, multi-level once a node's 2K entries are
    full; the tree's address, or None for a dataset without chunks."""
    data, chunks, ndim = d.data, d.chunks, d.data.ndim
    key_size = 8 + 8 * (ndim + 1)

    def key(size, mask, origin):
        return struct.pack(f"<II{ndim + 1}Q", size, mask, *origin, 0)

    entries, last = [], None
    for g in np.ndindex(*[-(-n // c) for n, c in zip(data.shape, chunks)]):
        origin = tuple(i * c for i, c in zip(g, chunks))
        block = data[tuple(slice(o, o + c) for o, c in zip(origin, chunks))]
        if block.shape != chunks:
            full = np.zeros(chunks, data.dtype)
            full[tuple(slice(0, n) for n in block.shape)] = block
            block = full
        raw, mask = _encode_chunk(np.ascontiguousarray(block).tobytes(), d.filters)
        entries.append((key(len(raw), mask, origin), w.put(raw)))
        last = origin
    if not entries:
        return None
    # the right bound of the last chunk: one chunk further in every dimension
    end = key(0, 0, tuple(o + c for o, c in zip(last, chunks)))
    node_size = 8 + 2 * 8 + 2 * _CHUNK_K * (key_size + 8) + key_size
    level = 0
    while True:
        parts = [entries[i:i + 2 * _CHUNK_K] for i in range(0, len(entries), 2 * _CHUNK_K)]
        first = w.pos + (-w.pos) % 8
        nodes = []
        for k, part in enumerate(parts):
            right = parts[k + 1][0][0] if k + 1 < len(parts) else end
            node = (b"TREE" + struct.pack("<BBH", 1, level, len(part))
                    + _enc_addr(None if k == 0 else first + (k - 1) * node_size)
                    + _enc_addr(None if k + 1 == len(parts) else first + (k + 1) * node_size)
                    + b"".join(kb + struct.pack("<Q", a) for kb, a in part) + right)
            nodes.append((part[0][0], w.put(node + bytes(node_size - len(node)))))
        if len(nodes) == 1:
            return nodes[0][1]
        entries, level = nodes, level + 1


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

    def create_dataset(self, name: str, data, **kwargs):
        self._require_new()
        return self._root.create_dataset(name, data, **kwargs)

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
