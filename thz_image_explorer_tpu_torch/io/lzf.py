"""The LZF codec of h5py's lzf filter (HDF5 filter id 32000).

:func:`decompress` and :func:`compress` call ``csrc/lzf.c`` (host C, built
with the system C compiler at first use by ``kernels.load``; a failed
build raises with the compiler's output). :func:`decompress_plain` and
:func:`compress_plain` are the same algorithms in Python, for the tests:
they give the same bytes. The compressor is this package's own (the
position of each 3-byte prefix in a hash table, matches at most 8 KiB back
and 264 bytes long); any LZF decoder, h5py's filter included, reads its
output.
"""

from __future__ import annotations

import ctypes

from thz_image_explorer_tpu_torch import kernels

_HASH_BITS = 14
_MAX_LITERAL = 32
_MAX_OFFSET = 8192
_MAX_MATCH = 264


def decompress(data: bytes, size: int) -> bytearray:
    """The ``size`` bytes an LZF stream decodes to (not copied into a
    ``bytes``); ``ValueError`` if it is malformed or decodes to any other
    length."""
    data = bytes(data)
    out = bytearray(size)
    buf = (ctypes.c_char * size).from_buffer(out) if size else None
    n = kernels.load("lzf").thz_lzf_decompress(data, len(data), buf, size)
    if n == -1:
        raise ValueError("malformed LZF stream")
    if n == -2 or n != size:
        raise ValueError(f"the LZF stream decodes to {'more' if n == -2 else n} bytes, "
                         f"expected {size}")
    return out


def compress(data: bytes) -> bytes | None:
    """``data`` as an LZF stream no longer than itself, or None where it
    does not shrink to that (h5py then stores the chunk as it is)."""
    data = bytes(data)
    out = bytearray(len(data))
    buf = (ctypes.c_char * len(data)).from_buffer(out) if data else None
    n = kernels.load("lzf").thz_lzf_compress(data, len(data), buf, len(data))
    if n < 0:
        raise MemoryError("the LZF compressor could not allocate its table")
    return bytes(out[:n]) if n else None


def decompress_plain(data: bytes, size: int) -> bytes:
    """:func:`decompress` in Python."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:
            length = ctrl + 1
            if ip + length > n:
                raise ValueError("malformed LZF stream")
            out += data[ip:ip + length]
            ip += length
        else:
            length = ctrl >> 5
            if length == 7:
                if ip >= n:
                    raise ValueError("malformed LZF stream")
                length += data[ip]
                ip += 1
            if ip >= n:
                raise ValueError("malformed LZF stream")
            back = ((ctrl & 31) << 8) + data[ip] + 1
            ip += 1
            if back > len(out):
                raise ValueError("malformed LZF stream")
            for _ in range(length + 2):
                out.append(out[-back])
        if len(out) > size:
            raise ValueError(f"the LZF stream decodes to more bytes, expected {size}")
    if len(out) != size:
        raise ValueError(f"the LZF stream decodes to {len(out)} bytes, expected {size}")
    return bytes(out)


def _hash3(data, i: int) -> int:
    v = (data[i] << 16) | (data[i + 1] << 8) | data[i + 2]
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - _HASH_BITS)


def compress_plain(data: bytes) -> bytes | None:
    """:func:`compress` in Python."""
    n = len(data)
    if n == 0:
        return None
    table = [0] * (1 << _HASH_BITS)  # position + 1, 0: none
    out = bytearray(1)
    run, lit, ip = 0, 0, 0  # run: the control byte of the open literal run
    while ip < n:
        if ip + 2 < n:
            h = _hash3(data, ip)
            ref = table[h]
            table[h] = ip + 1
            if ref and ip - ref < _MAX_OFFSET and data[ref - 1:ref + 2] == data[ip:ip + 3]:
                ref -= 1
                most = min(n - ip, _MAX_MATCH)
                length = 3
                while length < most and data[ref + length] == data[ip + length]:
                    length += 1
                if lit:
                    out[run] = lit - 1
                else:
                    del out[-1]  # no literal before the match: give its control byte back
                off, code = ip - ref - 1, length - 2
                out += bytes([(off >> 8) + (code << 5)]) if code < 7 else \
                    bytes([(off >> 8) + (7 << 5), code - 7])
                out.append(off & 0xFF)
                if len(out) > n:
                    return None
                for k in range(ip + 1, min(ip + length, n - 2)):
                    table[_hash3(data, k)] = k + 1
                ip += length
                lit, run = 0, len(out)
                out.append(0)
                continue
        if len(out) >= n:
            return None
        out.append(data[ip])
        ip += 1
        lit += 1
        if lit == _MAX_LITERAL:
            out[run] = _MAX_LITERAL - 1
            lit, run = 0, len(out)
            out.append(0)
    if lit:
        out[run] = lit - 1
    else:
        del out[-1]
    return bytes(out) if len(out) <= n else None
