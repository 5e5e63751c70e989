"""The port's HDF5 reader on the files the JAX package opens through h5py.

Beyond ``tests/test_torch_hdf5.py``: the ``libver="latest"`` chunk indexes
(implicit, extensible array, v2 B-tree) under each filter and with the
unlimited dimension first, second or both; the extensible array's element
order against HDF5's own chunk addresses; super blocks, paged data blocks
and regions grown past the data; the lzf filter (``csrc/lzf.c``) against
its plain Python version; enum, compound, array and variable-length string
types; side datasets the port cannot read (listed and opened, refused only
when read); the port's chunked writer read by h5py; and the committed
fixtures of ``tests/data/torch_hdf5/``. h5py writes the files and reads the
port's; the JAX package's ``open_scan_host`` / ``load_metadata`` are the
reference of the loaders.
"""

import dataclasses
import json
import pathlib
import sys

import h5py
import numpy as np
import pytest
import torch

from make_sample import synthetic_scan
from thz_image_explorer_tpu.io import dotthz as jdotthz
from thz_image_explorer_tpu.psf_tool.data_loader import KnifeEdgeMeasurement as JKnife
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
from thz_image_explorer_tpu_torch.io import hdf5, lzf
from thz_image_explorer_tpu_torch.parallel import mesh as pm
from thz_image_explorer_tpu_torch.parallel import open_scan_sharded
from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement as TKnife

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "torch_hdf5"
FILTERS = {"unfiltered": {}, "gzip_shuffle": dict(compression="gzip", shuffle=True),
           "lzf": dict(compression="lzf"), "fletcher32": dict(fletcher32=True)}
#: cube maxshape -> the chunk index HDF5 picks under libver="latest" (a
#: fixed array numbers its chunks over the maximum shape's chunk counts)
MAXSHAPES = {"unlimited0": ((None, 6, 24), "earray"), "unlimited1": ((9, None, 24), "earray"),
             "two_unlimited": ((None, None, 24), "btree2"),
             "fixed_larger": ((11, 12, 24), "farray")}
SLICES = [(), (slice(1, 8, 3), slice(None), slice(2, 23, 5)), (4, slice(1, 5), 7),
          (Ellipsis, slice(20, 24)), (slice(8, 9), 5)]


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object or b.dtype == object:
        return a.dtype == b.dtype and a.shape == b.shape and a.tolist() == b.tolist()
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_values(a, b):
    """Equal types, dtypes, shapes and values; a compound compared member
    by member (h5py leaves the bytes between members uninitialized)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, (str, bytes)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.names:
        return all(same_values(a[n], b[n]) for n in a.dtype.names)
    return same_bits(a, b)


def h5py_scan(path, libver="latest", side=None, **ds2):
    """A dotTHz scan written by h5py (9 x 6 pixels x 24 samples), its cube
    stored with the ``ds2`` keywords; ``side(group)`` adds datasets."""
    t, cube = synthetic_scan(width=9, height=6, n_time=24)
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("Image")
        md = {"width": "9", "height": "6", "dx [mm]": "0.5", "dy [mm]": "0.5"}
        for k, v in {"description": "features", "user": "o/u/e/i", "thzVer": "1.00",
                     "mdDescription": ",".join(md), "dsDescription": "time,dataset",
                     **{f"md{i + 1}": v for i, v in enumerate(md.values())}}.items():
            g.attrs[k] = v
        g.create_dataset("ds1", data=t)
        g.create_dataset("ds2", data=cube, **ds2)
        if side:
            side(g)
    return cube


def assert_loaders_agree(path, monkeypatch, sharded=True):
    """open_scan_host, load_metadata and (2 ranks) open_scan_sharded of the
    port against the JAX package's open_scan_host / load_metadata."""
    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")
    path = str(path)
    port, ref = tdotthz.open_scan_host(path), jdotthz.open_scan_host(path)
    assert same_bits(port.data, ref.data) and same_bits(port.time, ref.time)
    assert dataclasses.asdict(port.metadata) == dataclasses.asdict(ref.metadata) \
        == dataclasses.asdict(tdotthz.load_metadata(path)) \
        == dataclasses.asdict(jdotthz.load_metadata(path))
    if sharded:
        blocks = [open_scan_sharded(path, pm.Mesh((1, 2), rank=r), device="cpu")[0]
                  for r in range(2)]
        assert same_bits(torch.cat([b.data for b in blocks], 1).numpy(),
                         ref.data - ref.data[..., :1])


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("maxshape", MAXSHAPES)
def test_chunk_indexes_read_bit_for_bit(tmp_path, maxshape, filt, monkeypatch):
    """Each libver="latest" index of a growable cube under each filter:
    whole reads, strided slices and the stored chunks as h5py reads them,
    the loaders as the JAX package's."""
    path = tmp_path / "scan.thz"
    shape, index = MAXSHAPES[maxshape]
    h5py_scan(path, maxshape=shape, chunks=(2, 4, 8), **FILTERS[filt])
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        d, hd = f["Image"]["ds2"], h["Image"]["ds2"]
        d._prepare()
        assert d._index == index
        assert (d.shape, d.maxshape, d.chunks, d.dtype) == (hd.shape, hd.maxshape, hd.chunks,
                                                          hd.dtype)
        for key in SLICES:
            assert same_bits(d[key], hd[key]), key
        for origin in ((0, 0, 0), (8, 4, 16)):
            assert d.read_direct_chunk(origin) == hd.id.read_direct_chunk(origin)
    assert_loaders_agree(path, monkeypatch)


def test_implicit_index(tmp_path, monkeypatch):
    """Chunks allocated early and never filtered: back to back in row-major
    order over the chunk counts of the maximum shape."""
    path = tmp_path / "scan.thz"
    cube = h5py_scan(path)
    with h5py.File(path, "a") as f:
        del f["Image"]["ds2"]
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((2, 4, 8))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        space = h5py.h5s.create_simple(cube.shape, (11, 6, 24))
        d = h5py.h5d.create(f["Image"].id, b"ds2", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, cube)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        d, hd = f["Image"]["ds2"], h["Image"]["ds2"]
        d._prepare()
        assert d._index == "implicit" and same_bits(d[()], cube)
        for key in SLICES:
            assert same_bits(d[key], hd[key]), key
        chunks = d._chunk_addresses()  # the maximum shape's, allocated early
        assert len(chunks) == 6 * 2 * 3
        for g in np.ndindex(5, 2, 3):
            origin = (g[0] * 2, g[1] * 4, g[2] * 8)
            assert chunks[origin][0] == hd.id.get_chunk_info_by_coord(origin).byte_offset
    assert_loaders_agree(path, monkeypatch)


@pytest.mark.parametrize("unlimited", [0, 1, 2])
def test_extensible_array_order_matches_hdf5(tmp_path, unlimited):
    """The element of each chunk is HDF5's: the unlimited dimension moved to
    the front, the others numbered over their maximum shape's chunk counts
    (here larger than the data's). Every chunk's stored bytes are its block
    of the data and what h5py's read_direct_chunk gives (filtered: sizes
    and masks too). HDF5 1.14's get_chunk_info_by_coord agrees only while
    the unlimited dimension is the first: otherwise it names the chunk of
    another block (its chunk iteration does not undo the swizzle), while
    HDF5's reads and read_direct_chunk do."""
    shape, chunks = (5, 7, 6), (2, 3, 2)
    maxshape = [9, 11, 8]
    maxshape[unlimited] = None
    data = np.random.default_rng(unlimited).standard_normal(shape).astype("<f8")
    path = tmp_path / "ea.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("raw", data=data, chunks=chunks, maxshape=tuple(maxshape))
        f.create_dataset("lzf", data=np.round(data), chunks=chunks, maxshape=tuple(maxshape),
                         compression="lzf")
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        for name in ("raw", "lzf"):
            d, hd = f[name], h[name]
            d._prepare()
            assert d._index == "earray"
            got = d._chunk_addresses()
            assert len(got) == hd.id.get_num_chunks() == 27
            for g in np.ndindex(*[-(-n // c) for n, c in zip(shape, chunks)]):
                origin = tuple(i * c for i, c in zip(g, chunks))
                mask, stored = d.read_direct_chunk(origin)
                assert (mask, stored) == hd.id.read_direct_chunk(origin), origin
                if name == "raw":
                    block = np.zeros(chunks, "<f8")
                    part = data[tuple(slice(o, o + c) for o, c in zip(origin, chunks))]
                    block[tuple(slice(0, n) for n in part.shape)] = part
                    assert stored == block.tobytes(), origin
                if unlimited == 0:
                    info = hd.id.get_chunk_info_by_coord(origin)
                    assert got[origin] == (info.byte_offset, info.size, info.filter_mask)
            assert same_bits(d[()], hd[()])


def test_extensible_array_super_blocks_and_pages(tmp_path):
    """140 000 one-line chunks reach every kind of block under HDF5's
    defaults: the index block's elements (4) and data blocks, super blocks,
    and from element 4 + 131 056 on data blocks of 2 048 elements in pages
    of 1 024; grown by 1 000 lines never written, which read as the fill
    value."""
    n = 140_000
    x = np.random.default_rng(5).integers(0, 255, (n, 2), np.uint8)
    path = tmp_path / "big.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", data=x, chunks=(1, 2), maxshape=(None, 2), fillvalue=7)
        d.resize(n + 1000, axis=0)
    blob = path.read_bytes()
    assert blob.count(b"EASB") >= 10 and n > 4 + 131_056
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        whole = f["d"][()]
        assert same_bits(whole, h["d"][()])
        assert same_bits(whole[:n], x) and (whole[n:] == 7).all()
        for key in (slice(131_000, 140_500, 7), (slice(135_000, 139_000), 1)):
            assert same_bits(f["d"][key], h["d"][key]), key


@pytest.mark.parametrize("layout", ["earliest", "unlimited0", "two_unlimited"])
def test_grown_unwritten_region_reads_the_fill_value(tmp_path, layout):
    """A cube grown past its data (a v1 B-tree, an extensible array, a v2
    B-tree): the chunks never written read as the fill value, as in h5py."""
    path = tmp_path / "grown.h5"
    maxshape = {"earliest": (None, 6, 24), "unlimited0": (None, 6, 24),
                "two_unlimited": (None, None, 24)}[layout]
    data = np.random.default_rng(6).standard_normal((4, 6, 24)).astype("<f4")
    with h5py.File(path, "w", libver="earliest" if layout == "earliest" else "latest") as f:
        d = f.create_dataset("d", data=data, chunks=(2, 4, 8), maxshape=maxshape,
                             fillvalue=-2.5, compression="gzip")
        d.resize(7, axis=0)
        if layout == "two_unlimited":
            d.resize(9, axis=1)
            d[5, 7] = 1.0  # one chunk written in the grown region
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        for key in ((), (slice(3, 7), slice(None, None, 2)), (6,)):
            assert same_bits(f["d"][key], h["d"][key]), key
        assert (f["d"][4:, :6] == -2.5).all()


def lzf_cases():
    rng = np.random.default_rng(7)
    return {
        "random_1": rng.integers(0, 256, 1, np.uint8).tobytes(),
        "random_5000": rng.integers(0, 256, 5000, np.uint8).tobytes(),
        "zeros_3": bytes(3),
        "zeros_70000": bytes(70_000),
        "floats": np.round(np.cumsum(rng.standard_normal(20_000)) * 4).astype("<f4").tobytes(),
        "text": b"THz time-domain spectroscopy; " * 700,
        "far_matches": rng.integers(0, 256, 8190, np.uint8).tobytes() * 3,
        "small_alphabet": rng.integers(0, 3, 30_000, np.uint8).tobytes(),
    }


@pytest.mark.parametrize("case", list(lzf_cases()))
def test_lzf_c_against_plain(case):
    """The C compressor and decoder give the plain versions' bytes, and a
    stream decodes back to its input in both (h5py's filter reads the
    port's streams in test_port_chunked_files_read_in_h5py)."""
    data = lzf_cases()[case]
    packed = lzf.compress(data)
    assert packed == lzf.compress_plain(data)
    if packed is None:  # it does not shrink: h5py stores such a chunk as it is
        assert case in ("random_1", "random_5000", "zeros_3")
        return
    assert len(packed) <= len(data)
    assert lzf.decompress(packed, len(data)) == data == lzf.decompress_plain(packed, len(data))


@pytest.mark.parametrize("stream,size", [
    (b"\x00", 1),              # a literal cut short
    (b"\xe0", 9),              # a long reference cut short
    (b"\x00a\x20", 4),         # a reference without its offset byte
    (b"\x00a\x20\x01", 4),     # a reference before the start
    (b"\x01ab", 3),            # fewer bytes than the chunk's
    (b"\x01ab\x20\x01", 3),    # more bytes than the chunk's
], ids=["literal", "long_reference", "offset", "before_start", "short", "long"])
def test_lzf_refuses_malformed_streams(stream, size):
    for decode in (lzf.decompress, lzf.decompress_plain):
        with pytest.raises(ValueError):
            decode(stream, size)


@pytest.mark.parametrize("filters", [
    dict(), dict(compression="gzip"), dict(compression="gzip", compression_opts=9, shuffle=True),
    dict(compression="lzf"), dict(compression="lzf", shuffle=True), dict(shuffle=True)],
    ids=["unfiltered", "gzip", "gzip9_shuffle", "lzf", "lzf_shuffle", "shuffle"])
@pytest.mark.parametrize("shape,chunks", [((7, 5, 33), (2, 3, 8)), ((5000,), (1,))],
                         ids=["edge_chunks", "three_levels"])
def test_port_chunked_files_read_in_h5py(tmp_path, shape, chunks, filters):
    """create_dataset with h5py's keywords writes a v1 B-tree (three levels
    at 5 000 chunks: 2K = 64 entries a node), a filter pipeline v1 and
    chunks h5py reads bit for bit, slices and stored chunks too; lzf leaves
    a chunk it cannot shrink as it is, its mask bit set, as h5py does."""
    rng = np.random.default_rng(8)
    path = tmp_path / "port.h5"
    arrays = {"f4": np.round(rng.standard_normal(shape) * 4).astype("<f4"),
              "f8be_noise": rng.standard_normal(shape).astype(">f8"),
              "i2": rng.integers(-300, 300, shape).astype("<i2")}
    with hdf5.File(path, "w") as f:
        g = f.create_group("Image")
        for name, a in arrays.items():
            g.create_dataset(name, data=a, chunks=chunks, **filters)
    with h5py.File(path, "r") as h, hdf5.File(path) as f:
        for name, a in arrays.items():
            hd, d = h["Image"][name], f["Image"][name]
            assert hd.chunks == chunks and hd.compression == filters.get("compression")
            assert hd.shuffle == filters.get("shuffle", False)
            assert same_bits(hd[()], a) and same_bits(d[()], a)
            key = (slice(1, 6, 2), 4, slice(3, 30, 4)) if len(shape) == 3 else slice(10, 4990, 9)
            assert same_bits(hd[key], a[key]), name
            last = tuple((n - 1) // c * c for n, c in zip(shape, chunks))
            for origin in ((0,) * len(shape), last):
                assert d.read_direct_chunk(origin) == hd.id.read_direct_chunk(origin)
    if len(shape) == 1:
        assert path.read_bytes().count(b"TREE") > 80  # 79 leaves, 2 internal nodes, a root


def test_port_lzf_stores_an_incompressible_chunk_as_it_is(tmp_path):
    noise = np.random.default_rng(9).integers(0, 2**31, (4, 256), np.int32)
    noise[1] = 5
    path = tmp_path / "lzf.h5"
    with hdf5.File(path, "w") as f:
        f.create_dataset("d", data=noise, chunks=(1, 256), compression="lzf")
    with h5py.File(path, "r") as h:
        assert [h["d"].id.get_chunk_info(i).filter_mask for i in range(4)] == [1, 0, 1, 1]
        assert same_bits(h["d"][()], noise)


NESTED = np.dtype([("a", "<f4"), ("b", [("c", "<i2"), ("d", ">f8")]), ("e", "?"),
                   ("f", "<u2", (2, 3))])
PADDED = np.dtype({"names": ["x", "y"], "formats": ["<i4", "<f8"], "offsets": [0, 8],
                   "itemsize": 24})


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_types_as_h5py_reads_them(tmp_path, libver, monkeypatch):
    """Boolean and other enums, compounds (nested, padded, complex) and
    array types in attributes and datasets, variable-length string
    datasets: the values and dtypes h5py gives, the metadata strings the
    JAX package makes of them."""
    path = tmp_path / "types.thz"
    values = {"flag": np.True_, "off": np.False_, "bools": np.array([True, False]),
              "pair": np.zeros((), [("a", "<f4"), ("b", "<i4")])[()],
              "nested": np.ones((), NESTED)[()], "padded": np.ones((2,), PADDED),
              "window": np.arange(3.0), "phasor": np.complex64(1 - 2j),
              "phasors": np.array([1 + 2j, 3 - 1j])}

    def side(g):
        g.attrs["mdDescription"] = ",".join(["dx [mm]", "dy [mm]", *values, "colour", "grid"])
        g.attrs["md1"] = g.attrs["md2"] = "0.5"
        for i, v in enumerate(values.values()):
            g.attrs[f"md{i + 3}"] = v
        g.attrs.create(f"md{len(values) + 3}", 2, dtype=h5py.enum_dtype({"A": 0, "B": 2}, "i2"))
        g.attrs.create(f"md{len(values) + 4}", np.arange(6).reshape(2, 3),
                       dtype=np.dtype(("<i4", (3,))), shape=(2, 3))
        g["note"] = "a note é"
        g["notes"] = np.array(["a", "", "bbb"], dtype=h5py.string_dtype())
        g.create_dataset("vchunked", data=np.array(["x" * i for i in range(40)],
                                                   dtype=h5py.string_dtype()),
                         chunks=(7,), compression="gzip")
        g.create_dataset("cmp", data=np.ones((4, 3), NESTED), chunks=(2, 3))
        g.create_dataset("bool", data=np.array([[True, False], [False, True]]), chunks=(1, 2))
        g.create_dataset("enum", data=np.array([0, 2, 2], "i1"),
                         dtype=h5py.enum_dtype({"A": 0, "B": 2}, "i1"))
        a = g.create_dataset("subarray", shape=(4,), dtype=np.dtype(("<f4", (2, 3))))
        a[...] = np.arange(24, dtype="f4").reshape(4, 2, 3)
        g.create_dataset("complex", data=(np.arange(6) + 1j).reshape(2, 3), chunks=(1, 3),
                         compression="lzf")

    h5py_scan(path, libver, side=side)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        pa, ha = f["Image"].attrs, h["Image"].attrs
        assert pa.keys() == list(ha.keys())
        for k in ha.keys():
            assert same_values(pa[k], ha[k]), k
            assert tdotthz._attr_str(pa[k]) == jdotthz._attr_str(ha[k]), k
        for k in ("note", "notes", "vchunked", "cmp", "bool", "enum", "subarray", "complex"):
            d, hd = f["Image"][k], h["Image"][k]
            assert (d.shape, d.dtype) == (hd.shape, hd.dtype), k
            assert same_values(d[()], hd[()]), k
        assert same_values(f["Image"]["vchunked"][5:30:4], h["Image"]["vchunked"][5:30:4])
        assert same_values(f["Image"]["subarray"][1:3], h["Image"]["subarray"][1:3])
    md = tdotthz.load_metadata(str(path)).md
    assert md["flag"] == "True" and md["pair"] == "(0.0, 0)" and md["colour"] == "2"
    assert_loaders_agree(path, monkeypatch)


def _virtual(g):
    layout = h5py.VirtualLayout(shape=(4, 3), dtype="f4")
    layout[:] = h5py.VirtualSource("missing.h5", "d", shape=(4, 3))
    g.create_virtual_dataset("a_side", layout, fillvalue=0)


def _external(g):
    g.create_dataset("a_side", shape=(4, 3), dtype="f4",
                     external=[("side.bin", 0, h5py.h5f.UNLIMITED)])


def _scaleoffset(g):
    g.create_dataset("a_side", data=np.arange(12.0).reshape(4, 3), chunks=(2, 3), scaleoffset=2)


def _note(g):
    g["a_side"] = "a note"


SIDES = {"virtual": (_virtual, "virtual dataset layout"),
         "external": (_external, "external data storage"),
         "scaleoffset": (_scaleoffset, "filter scale-offset"),
         "note": (_note, None)}


@pytest.mark.parametrize("kind", SIDES)
def test_side_datasets_refused_only_when_read(tmp_path, kind, monkeypatch):
    """A dataset sorted before the scan's that the port cannot read is
    listed and opened with its shape: the loaders give the JAX package's
    scan and metadata, and only reading it raises, naming the feature (the
    note reads as h5py reads it)."""
    make, feature = SIDES[kind]
    path = tmp_path / "side.thz"
    h5py_scan(path, "earliest", side=make)
    assert_loaders_agree(path, monkeypatch)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        assert f["Image"].keys() == list(h["Image"].keys())
        d = f["Image"]["a_side"]
        assert (d.shape, d.ndim, d.dtype) == (h["Image"]["a_side"].shape,
                                              h["Image"]["a_side"].ndim,
                                              h["Image"]["a_side"].dtype)
        if feature is None:
            assert same_values(d[()], h["Image"]["a_side"][()])
        else:
            with pytest.raises(hdf5.UnsupportedFeature, match=feature):
                d[()]


def test_knife_edge_group_with_a_side_dataset(tmp_path):
    """A position group holding a virtual dataset beside its trace loads
    as the JAX loader loads it."""
    path = tmp_path / "knife.thz"
    t = np.arange(31) * 0.05
    rng = np.random.default_rng(10)
    with h5py.File(path, "w") as f:
        for i in range(5):
            g = f.create_group(f"Beam Width Measurement x={i * 0.1:.2f}")
            g.create_dataset("ds1", data=np.stack([t, rng.standard_normal(31)], 1))
            if i == 2:
                layout = h5py.VirtualLayout(shape=(31, 2), dtype="f8")
                layout[:] = h5py.VirtualSource("missing.h5", "d", shape=(31, 2))
                g.create_virtual_dataset("ds2", layout)
    port, ref = TKnife.from_thz_file(str(path)), JKnife.from_thz_file(str(path))
    for a, b in ((port.positions, ref.positions), (port.time_traces, ref.time_traces),
                 (port.times, ref.times)):
        assert same_bits(a, b)


def _corrupt(path, sig, nth=0, at=8):
    blob = bytearray(path.read_bytes())
    pos = -1
    for _ in range(nth + 1):
        pos = blob.index(sig, pos + 1)
    blob[pos + at] ^= 0x5A
    path.write_bytes(bytes(blob))


@pytest.mark.parametrize("where", ["EAHD", "EAIB", "EASB", "EADB", "BTHD", "BTLF", "lzf"])
def test_damaged_index_raises(tmp_path, where):
    """A flipped byte in a chunk index structure fails its checksum, a
    damaged lzf stream fails to decode: HDF5Error, never a wrong array."""
    path = tmp_path / "bad.h5"
    data = np.round(np.random.default_rng(11).standard_normal((400, 8)) * 4)
    maxshape = (None, None) if where.startswith("BT") else (None, 8)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("d", data=data, chunks=(1, 8), maxshape=maxshape,
                         compression="lzf" if where == "lzf" else None)
        first = f["d"].id.get_chunk_info(0).byte_offset
    if where == "lzf":
        blob = bytearray(path.read_bytes())
        blob[first] = 0xE0  # a long back reference at the start of the output
        path.write_bytes(bytes(blob))
    else:
        _corrupt(path, where.encode())
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.HDF5Error):
            f["d"][()]


def _fixture_module():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import make_torch_hdf5_fixtures
    finally:
        sys.path.pop(0)
    return make_torch_hdf5_fixtures


FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.thz"))


def test_fixture_list_is_the_scripts():
    assert FIXTURE_FILES == sorted(_fixture_module().FILES)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1 << 20


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_committed_fixtures(name, monkeypatch):
    """Each committed fixture opens in h5py and in the port with the arrays
    its script regenerates from the seed with numpy, and the metadata that
    expected.json holds is the JAX package's and the port's: a stale
    fixture fails here, not on the card."""
    expected = json.loads((FIXTURES / "expected.json").read_text())
    arrays = _fixture_module().fixture_arrays(expected["seed"])[name]
    path = FIXTURES / name
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        assert sorted(arrays) == f["Image"].keys() == list(h["Image"].keys())
        for k, want in arrays.items():
            assert same_values(f["Image"][k][()], want), k
            assert same_values(h["Image"][k][()], want), k
        with h5py.File(path, "r") as h2:
            assert dataclasses.asdict(jdotthz.read_group_metadata(h2["Image"])) \
                == expected["files"][name]["metadata"]
    assert_loaders_agree(path, monkeypatch, sharded=False)
    assert dataclasses.asdict(tdotthz.load_metadata(str(path))) \
        == expected["files"][name]["metadata"]
