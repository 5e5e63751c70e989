"""The port's own HDF5 reader and writer (``io/hdf5.py``) on the CPU.

h5py stays a dependency of the tests only: it writes the fixtures (both
``libver`` settings) and reads back what the port writes. The port reads
every case bit for bit as h5py does, slices included, with the same
attributes; h5py and the JAX package read the port's files bit for bit;
``update_metadata`` changes the metadata in place and moves no dataset
byte; unsupported features and damaged files raise errors naming them;
and with h5py made unimportable every file entry point of the port runs.
"""

import dataclasses
import os
import pathlib
import re
import sys

import h5py
import numpy as np
import pytest
import torch

from make_sample import synthetic_scan, write_pulse_thz, write_scan_thz
from thz_image_explorer_tpu.io import dotthz as jdotthz
from thz_image_explorer_tpu.psf_tool.data_loader import KnifeEdgeMeasurement as JKnife
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
from thz_image_explorer_tpu_torch.io import hdf5
from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement as TKnife

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIBVERS = ["earliest", "latest"]
LAYOUTS = ["contiguous", "compact", "gzip_shuffle", "gzip_shuffle_fletcher32"]
DTYPES = ["<f4", "<f8", "<i4", ">f4"]
SHAPES = [(), (13,), (7, 5), (7, 5, 13)]
SLICES = {
    1: [slice(2, 9), slice(None, None, 3), -1, (Ellipsis,)],
    2: [(slice(1, 6), 3), (slice(None, None, 2), slice(1, None, 3)), (4,), (Ellipsis, 0)],
    3: [(slice(1, 6, 2), slice(0, 5, 3), slice(4, 12)), (2, slice(None), 5),
        (slice(3, 4), 1, slice(0, 13, 5)), (Ellipsis, slice(11, 13))],
}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def fields(md):
    """A metadata object of either package as a dict."""
    return dataclasses.asdict(md)


def assert_same_attrs(port, theirs):
    assert port.keys() == list(theirs.keys())
    for k in theirs.keys():
        a, b = port[k], theirs[k]
        assert type(a) is type(b), (k, a, b)
        assert a == b if isinstance(b, str) else same_bits(a, b), (k, a, b)


def write_attrs(node):
    """Both string kinds, numeric scalars and an array; 17 attributes, so
    ``libver="latest"`` stores them dense (more than 8)."""
    for k in range(12):
        node.attrs[f"s{k}"] = f"value {k} é"
    node.attrs["empty"] = ""
    node.attrs["fixed"] = np.bytes_(b"abc")
    node.attrs["num"] = 3.25
    node.attrs["int"] = np.int32(-7)
    node.attrs["arr"] = np.arange(3.0)


def write_case(path, libver, layout, dtype, shape, seed=0):
    data = np.asarray(np.random.default_rng(seed).standard_normal(shape) * 100).astype(dtype)
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("Image")
        write_attrs(g)
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple(shape) if shape else h5py.h5s.create(h5py.h5s.SCALAR)
            ds = h5py.h5d.create(g.id, b"ds", h5py.h5t.py_create(np.dtype(dtype)), space,
                                 dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
        elif layout == "contiguous":
            g.create_dataset("ds", data=data)
        else:
            chunks = tuple(max(1, n // 2) for n in shape)
            g.create_dataset("ds", data=data, chunks=chunks, compression="gzip", shuffle=True,
                             fletcher32=layout.endswith("fletcher32"))
    return data


# every libver x layout x dtype x rank but a chunked scalar (HDF5 has none)
CASES = [pytest.param(libver, layout, dtype, rank,
                      id=f"{libver}-{layout}-{dtype.replace('<', '').replace('>', 'be_')}-{rank}")
         for libver in LIBVERS for layout in LAYOUTS for dtype in DTYPES for rank in range(4)
         if rank or not layout.startswith("gzip")]


@pytest.mark.parametrize("libver,layout,dtype,rank", CASES)
def test_reads_h5py_files_bit_for_bit(tmp_path, libver, layout, dtype, rank):
    shape = SHAPES[rank]
    path = tmp_path / "case.h5"
    data = write_case(path, libver, layout, dtype, shape)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        assert f.keys() == list(h.keys()) == ["Image"]
        g, hg = f["Image"], h["Image"]
        assert hdf5.is_group(g) and not hdf5.is_dataset(g)
        assert_same_attrs(g.attrs, hg.attrs)
        d, hd = g["ds"], hg["ds"]
        assert hdf5.is_dataset(d)
        assert (d.shape, d.ndim, d.dtype) == (hd.shape, hd.ndim, hd.dtype)
        assert same_bits(d[()], hd[()]) and same_bits(d[()], data[()])
        for key in SLICES.get(rank, []):
            assert same_bits(d[key], hd[key]), key


@pytest.mark.parametrize("libver", LIBVERS)
def test_many_chunks_and_partial_writes(tmp_path, libver):
    """1500 chunks (a paged fixed array under "latest", a v1 B-tree with
    internal nodes under "earliest"), a single-chunk dataset, and chunks
    never written (the fill value)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(3000).astype("<f4")
    y = rng.standard_normal((40, 30, 20))
    path = tmp_path / "many.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=x, chunks=(2,), compression="gzip")
        f.create_dataset("x_raw", data=x, chunks=(2,))
        f.create_dataset("y", data=y, chunks=(3, 4, 5), shuffle=True, fletcher32=True)
        f.create_dataset("single", data=y, chunks=y.shape, compression="gzip")
        f.create_dataset("partial", shape=(100,), dtype="f4", chunks=(10,), fillvalue=7.5)
        f["partial"][20:35] = 1.0
    blob = path.read_bytes()
    assert blob.count(b"FADB" if libver == "latest" else b"TREE") > 1
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        for name in h.keys():
            assert same_bits(f[name][()], h[name][()]), name
            assert same_bits(f[name][5:17], h[name][5:17]), name
        key = (slice(1, 39, 7), 3, slice(2, 19, 4))
        assert same_bits(f["y"][key], h["y"][key])


@pytest.mark.parametrize("libver", LIBVERS)
def test_knife_edge_file_of_300_groups(tmp_path, libver):
    """Symbol-table groups with internal B-tree nodes, or dense links with
    an indirect heap block and a v2 B-tree internal node; the knife-edge
    loader gives the JAX package's measurement."""
    rng = np.random.default_rng(2)
    path = tmp_path / "knife.thz"
    t = np.arange(41) * 0.05
    with h5py.File(path, "w", libver=libver) as f:
        for i in rng.permutation(300):
            g = f.create_group(f"Beam Width Measurement x={-1.5 + i * 0.01:.2f}")
            g.attrs["description"] = f"position {i}"
            g.create_dataset("ds1", data=np.stack([t, rng.standard_normal(41)], 1))
    blob = path.read_bytes()
    if libver == "latest":
        assert b"FHIB" in blob and b"BTIN" in blob
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        assert f.keys() == list(h.keys()) and len(f.keys()) == 300
        for name in h.keys():
            assert same_bits(f[name]["ds1"][()], h[name]["ds1"][()])
            assert_same_attrs(f[name].attrs, h[name].attrs)
    port, ref = TKnife.from_thz_file(str(path)), JKnife.from_thz_file(str(path))
    for a, b in ((port.positions, ref.positions), (port.time_traces, ref.time_traces),
                 (port.times, ref.times)):
        assert same_bits(a, b)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", ">f4", "<u2"],
                         ids=["f4", "f8", "i4", "f4be", "u2"])
def test_port_files_read_in_h5py(tmp_path, dtype, rank):
    data = np.asarray(np.random.default_rng(3).standard_normal(SHAPES[rank]) * 100).astype(dtype)
    path = tmp_path / "port.h5"
    with hdf5.File(path, "w") as f:
        g = f.create_group("Image")
        write_attrs(g)
        g.create_dataset("ds", data=data)
    with h5py.File(path, "r") as h, hdf5.File(path) as f:
        assert same_bits(h["Image"]["ds"][()], data[()])
        assert h["Image"]["ds"].dtype == np.dtype(dtype)
        assert_same_attrs(f["Image"].attrs, h["Image"].attrs)
        assert h["Image"].attrs["s3"] == "value 3 é" and h["Image"].attrs["empty"] == ""


def test_port_files_nest_many_groups(tmp_path):
    """300 groups (symbol-table nodes under a two-level B-tree), an empty
    group and a nested one, listed by h5py in ascending byte order; the
    JAX package's knife-edge loader reads the port's file as the port's
    does."""
    path = tmp_path / "groups.h5"
    names = [f"Beam Width Measurement x={v:.2f}" for v in np.linspace(-1.5, 1.49, 300)]
    traces = np.random.default_rng(4).standard_normal((300, 3))
    with hdf5.File(path, "w") as f:
        f.create_group("empty")
        for i, name in enumerate(names):
            f.create_group(name).create_dataset(
                "ds1", data=np.stack([np.full(3, i, np.float64), traces[i]], 1))
        f.create_group("nested").create_group("inner").attrs["a"] = "b"
    with h5py.File(path, "r") as h:
        assert list(h.keys()) == sorted(names + ["empty", "nested"])
        assert len(h["empty"]) == 0 and h["nested/inner"].attrs["a"] == "b"
        for i, name in enumerate(names):
            assert same_bits(h[name]["ds1"][()][:, 1], traces[i])
    port, ref = TKnife.from_thz_file(str(path)), JKnife.from_thz_file(str(path))
    assert port.time_traces.shape == (300, 3)
    for a, b in ((port.positions, ref.positions), (port.time_traces, ref.time_traces),
                 (port.times, ref.times)):
        assert same_bits(a, b)


def test_save_scan_reads_in_jax_and_h5py(tmp_path, monkeypatch):
    """The Explorer's save_file through the port's writer; the JAX
    package's open_scan and load_metadata read it back."""
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")
    t, cube = synthetic_scan(width=12, height=10, n_time=64)
    md = tdotthz.DotthzMetadata(description="saved é", md={"dx [mm]": "0.5", "dy [mm]": "0.5"})
    ex = Explorer(device="cpu")
    ex.open_arrays(t, cube, md)
    ex.add_roi("u1", "roi-a", [(1, 1), (8, 1), (8, 7)])
    path = str(tmp_path / "saved.thzimg")
    ex.save_file(path)
    data = cube.astype(np.float32)
    data -= data[..., :1]  # save_file writes the open's cube, its DC offset removed
    with h5py.File(path, "r") as h:
        assert same_bits(h["Image"]["ds1"][()], t.astype(np.float32))
        assert same_bits(h["Image"]["ds2"][()], data)
    jcube, _, jmd = jdotthz.open_scan(path)
    assert same_bits(np.asarray(jcube.time), t.astype(np.float32))
    assert same_bits(np.asarray(jcube.data), data)
    assert fields(jmd) == fields(tdotthz.load_metadata(path)) and jmd.description == "saved é"
    assert jmd.get_rois() == [("roi-a", [(1, 1), (8, 1), (8, 7)])]


def _h5py_scan(path, libver, chunks=None, maxshape=None):
    """A scan written by h5py in the given format, its cube chunked and
    compressed when ``chunks`` is given (growable to ``maxshape``)."""
    t, cube = synthetic_scan(width=9, height=7, n_time=32)
    md = {"dx [mm]": "0.5", "dy [mm]": "0.5", "width": "9", "height": "7"}
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("Image")
        for k, v in {"description": libver, "user": "///", "thzVer": "1.00",
                     "mdDescription": ",".join(md), "dsDescription": "time,dataset",
                     **{f"md{i + 1}": v for i, v in enumerate(md.values())}}.items():
            g.attrs[k] = v
        g.create_dataset("ds1", data=t.astype(np.float32))
        kw = dict(chunks=chunks, compression="gzip", shuffle=True, maxshape=maxshape) \
            if chunks else {}
        g.create_dataset("ds2", data=cube.astype(np.float32), **kw)
    return cube.astype(np.float32)


def _port_scan(path):
    from thz_image_explorer_tpu_torch.data import make_cube

    t, cube = synthetic_scan(width=9, height=7, n_time=32)
    md = tdotthz.DotthzMetadata(md={"dx [mm]": "0.5", "dy [mm]": "0.5"},
                                ds_description=["time", "dataset"])
    tdotthz.save_scan(path, make_cube(t, torch.as_tensor(cube, dtype=torch.float32),
                                      device="cpu"), md)


@pytest.mark.parametrize("fmt", ["h5py-earliest", "h5py-latest", "port"])
def test_update_metadata_in_place(tmp_path, fmt):
    """update_metadata appends the group's new header and repoints its link:
    h5py and the JAX package read the new metadata, no dataset moves or
    changes, and the old bytes stay but for a few addresses and checksums."""
    path = str(tmp_path / "scan.thzimg")
    if fmt == "port":
        _port_scan(path)
    else:
        _h5py_scan(path, fmt[5:], chunks=(4, 4, 16) if fmt.endswith("latest") else None)
    with h5py.File(path, "r") as h:
        before = {k: (h["Image"][k][()], h["Image"][k].id.get_offset()) for k in h["Image"]}
    old = pathlib.Path(path).read_bytes()
    md = tdotthz.load_metadata(path)
    md.description, md.md = "updated", {**md.md, "ROI Labels": "a", "ROI 0": "[1,2],[3,4]"}
    tdotthz.update_metadata(path, md)
    md.md["extra é"] = "2"
    tdotthz.update_metadata(path, md)
    new = pathlib.Path(path).read_bytes()
    assert len(old) < len(new) < len(old) + 64 * 1024
    changed = sum(a != b for a, b in zip(old, new))
    assert changed <= 64, changed
    assert fields(jdotthz.load_metadata(path)) == fields(md) == fields(tdotthz.load_metadata(path))
    with h5py.File(path, "r") as h:
        assert h["Image"].attrs["description"] == "updated"
        for k, (arr, offset) in before.items():
            assert same_bits(h["Image"][k][()], arr) and h["Image"][k].id.get_offset() == offset
    # h5py can go on changing the file (into dense attributes under "latest")
    with h5py.File(path, "r+") as h:
        for i in range(12):
            h["Image"].attrs[f"z{i}"] = f"h5py {i}"
    assert fields(tdotthz.load_metadata(path)) == fields(md)
    with hdf5.File(path) as f:
        assert f["Image"].attrs["z11"] == "h5py 11"


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(100.0), chunks=(10,), compression="lzf")
    return lambda f: f["d"][()], np.arange(100.0)


def _extensible(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("d", data=np.arange(100.0), chunks=(10,), maxshape=(None,))
    return lambda f: f["d"][()], np.arange(100.0)


def _compound_attr(path):
    value = np.zeros((), dtype=[("a", "f4"), ("b", "i4")])
    with h5py.File(path, "w") as f:
        f.attrs["c"] = value
    return lambda f: f.attrs["c"], value[()]


@pytest.mark.parametrize("make", [_lzf, _extensible, _compound_attr],
                         ids=["lzf", "extensible_array", "compound_attribute"])
def test_reads_what_it_once_refused(tmp_path, make):
    """The lzf filter, the extensible-array chunk index and a compound
    attribute, refused before, read as h5py reads them."""
    path = tmp_path / "once_refused.h5"
    read, want = make(path)
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        got, theirs = read(f), read(h)
    assert type(got) is type(theirs) is type(want)
    assert got.dtype == theirs.dtype and got.tobytes() == theirs.tobytes() == want.tobytes()


def _scaleoffset(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(100.0), chunks=(10,), scaleoffset=2)
    return lambda f: f["d"][()]


def _reference_attr(path):
    with h5py.File(path, "w") as f:
        f.create_group("g")
        f.attrs.create("r", f["g"].ref, dtype=h5py.ref_dtype)
    return lambda f: f.attrs["r"]


def _vlen_sequence(path):
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", (2,), dtype=h5py.vlen_dtype(np.int32))
        d[0], d[1] = [1, 2], [3]
    return lambda f: f["d"][()]


def _truncated(path):
    write_scan_thz(str(path), np.arange(16, dtype=np.float32), np.ones((3, 3, 16), np.float32))
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) - 100])
    return lambda f: f["Image"]["ds2"][()]


def _bad_checksum(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_group("Image").attrs["a"] = "b"
    blob = bytearray(path.read_bytes())
    at = blob.index(b"OHDR", blob.index(b"OHDR") + 4)
    blob[at + 8] ^= 0xFF
    path.write_bytes(bytes(blob))
    return lambda f: f["Image"].attrs["a"]


def _bad_fletcher32(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(100.0), chunks=(50,), fletcher32=True)
        offset = f["d"].id.get_chunk_info(1).byte_offset
    blob = bytearray(path.read_bytes())
    blob[offset + 9] ^= 0x55
    path.write_bytes(bytes(blob))
    return lambda f: f["d"][()]


@pytest.mark.parametrize("make,match", [
    (_scaleoffset, "unsupported HDF5 feature: filter scale-offset"),
    (_reference_attr, "unsupported HDF5 feature: reference datatype"),
    (_vlen_sequence, "unsupported HDF5 feature: variable-length sequence type"),
    (_truncated, "truncated file"),
    (_bad_checksum, "checksum mismatch in object header"),
    (_bad_fletcher32, "fletcher32 checksum mismatch"),
], ids=["scaleoffset", "reference_attribute", "vlen_sequence", "truncated", "bad_checksum",
        "bad_fletcher32"])
def test_refuses_what_it_cannot_read(tmp_path, make, match):
    path = tmp_path / "bad.h5"
    read = make(path)
    with pytest.raises(hdf5.HDF5Error, match=match):
        with hdf5.File(path) as f:
            read(f)


def test_checksums_match_their_references():
    """lookup3 against Bob Jenkins' published hashlittle values,
    fletcher32 against HDF5's own chunk checksums."""
    assert hdf5.lookup3(b"", 0) == 0xDEADBEEF
    assert hdf5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert hdf5.lookup3(b"Four score and seven years ago", 0) == 0x17770551
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    for n in (1, 2, 719, 720, 721, 4001):
        data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
        # the slow reference: H5_checksum_fletcher32 word by word
        s1 = s2 = 0
        words = [(data[i] << 8) | data[i + 1] for i in range(0, n - 1, 2)]
        for start in range(0, len(words), 360):
            for w in words[start:start + 360]:
                s1 = (s1 + w) & 0xFFFFFFFF
                s2 = (s2 + s1) & 0xFFFFFFFF
            s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        if n % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        assert hdf5.fletcher32(data) == (s2 << 16) | s1, n


@pytest.mark.parametrize("libver,maxshape", [("earliest", None), ("latest", None),
                                             ("latest", (None, 7, 32)),
                                             ("latest", (None, None, 32))],
                         ids=["earliest", "latest", "extensible_array", "v2_btree"])
def test_a_block_read_decodes_only_its_chunks(tmp_path, libver, maxshape, monkeypatch):
    """open_arrays_sharded on the reader's dataset: a rank's block decodes
    the chunks it touches and no other (a v1 B-tree, a fixed array, an
    extensible array, a v2 B-tree)."""
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded

    path = tmp_path / "chunked.h5"
    _h5py_scan(str(path), libver, chunks=(4, 4, 16), maxshape=maxshape)
    decoded = []
    real = hdf5._decode_chunk
    monkeypatch.setattr(hdf5, "_decode_chunk",
                        lambda raw, *a: decoded.append(a[-1]) or real(raw, *a))
    index = {"earliest": "btree1", "latest": "farray", "extensible_array": "earray",
             "v2_btree": "btree2"}
    with hdf5.File(path) as f:
        g = f["Image"]
        g["ds2"]._prepare()
        assert g["ds2"]._index == index[libver if maxshape is None else
                                        "v2_btree" if maxshape[1] is None else
                                        "extensible_array"]
        whole = g["ds2"][()]
        n_all = len(decoded)
        for r in range(2):
            decoded.clear()
            mesh = pm.Mesh((1, 2), rank=r)
            cube, _, _ = open_arrays_sharded(g["ds1"][()], g["ds2"], mesh, device="cpu")
            x0, x1, y0, y1 = mesh.block(r, (9, 7))
            block = whole[x0:x1, y0:y1]
            assert same_bits(cube.data.numpy(), block - block[..., :1])
            touched = len(range(x0 // 4, (x1 - 1) // 4 + 1)) * len(range(y0 // 4, (y1 - 1) // 4 + 1))
            assert len(decoded) == touched * 2 < n_all  # 2 chunks along t (32 / 16)


@pytest.mark.parametrize("writer", ["h5py", "port"])
def test_jax_parity_on_both_writers(tmp_path, writer, monkeypatch):
    """The JAX package's open_scan, load_metadata and open_pulse give the
    port's arrays bit for bit and its metadata, whichever library wrote
    the file."""
    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")
    path, pulse = str(tmp_path / "scan.thzimg"), str(tmp_path / "pulse.thz")
    t = (np.arange(32) * 0.05).astype(np.float32)
    if writer == "h5py":
        write_scan_thz(path, *synthetic_scan(width=9, height=7, n_time=32), dx=0.5, dy=0.5)
        write_pulse_thz(pulse, t, np.cos(t).astype(np.float32))
    else:
        _port_scan(path)
        with hdf5.File(pulse, "w") as f:
            g = f.create_group("Reference")
            g.attrs["description"] = "pulse"
            g.create_dataset("ds1", data=np.stack([t, np.cos(t).astype(np.float32)], 1))
    cube, img, md = tdotthz.open_scan(path, "cpu")
    jcube, jimg, jmd = jdotthz.open_scan(path)
    assert same_bits(cube.time.numpy(), np.asarray(jcube.time))
    assert same_bits(cube.data.numpy(), np.asarray(jcube.data))
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-6)
    assert fields(md) == fields(jmd) == fields(jdotthz.load_metadata(path)) \
        == fields(tdotthz.load_metadata(path))
    (t_a, s_a, md_a), (t_b, s_b, md_b) = tdotthz.open_pulse(pulse), jdotthz.open_pulse(pulse)
    assert same_bits(t_a, t_b) and same_bits(s_a, s_b) and fields(md_a) == fields(md_b)


@pytest.fixture
def files(tmp_path):
    """A scan with two siblings, a pulse and a knife-edge file, written
    before h5py is made unimportable."""
    t, cube = synthetic_scan(width=12, height=10, n_time=64)
    scans = [write_scan_thz(str(tmp_path / f"{c}.thzimg"), t, cube * (i + 1))
             for i, c in enumerate("abc")]
    pulse = write_pulse_thz(str(tmp_path / "p.thz"), t, cube[3, 4])
    knife = str(tmp_path / "knife.thz")
    with h5py.File(knife, "w") as f:
        for i in range(6):
            f.create_group(f"Beam Width Measurement x={i * 0.1:.2f}").create_dataset(
                "ds1", data=np.stack([t, cube[i, 0]], 1).astype(np.float64))
    return scans, pulse, knife, cube


def test_file_entry_points_run_without_h5py(files, tmp_path, monkeypatch, capsys):
    from thz_image_explorer_tpu_torch import cli as tcli
    from thz_image_explorer_tpu_torch import web as tweb
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_scan_sharded
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    scans, pulse, knife, cube = files
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401, F811
    ex = Explorer(device="cpu")
    ex.open_file(scans[0])
    assert same_bits(ex.pipeline.input.data.numpy(), cube - cube[..., :1])
    ex.open_sibling(1)
    assert os.path.basename(ex.file_path) == "b.thzimg"
    saved = str(tmp_path / "saved.thzimg")
    ex.save_file(saved)
    md = Explorer.load_metadata(saved)
    md.md["note"] = "x"
    tdotthz.update_metadata(saved, md)
    assert tdotthz.load_metadata(saved).md["note"] == "x"
    second = (cube * 2).astype(np.float32)
    assert same_bits(tdotthz.open_scan_host(saved).data, second - second[..., :1])
    t, sig, _ = tdotthz.open_pulse(pulse)
    assert same_bits(sig, cube[3, 4].astype(np.float32))
    blocks = [open_scan_sharded(scans[0], pm.Mesh((1, 2), rank=r), device="cpu")[0]
              for r in range(2)]
    assert same_bits(torch.cat([b.data for b in blocks], 1).numpy(), cube - cube[..., :1])
    assert TKnife.from_thz_file(knife).time_traces.shape == (6, 64)
    assert tcli.main(["info", scans[0], "--device", "cpu"]) == 0
    assert "12 x 10 pixels x 64 samples" in capsys.readouterr().out
    app = tweb.WebApp(device="cpu")
    try:
        out = app.preview(scans[0])
        assert out["groups"] == ["Image"] and out["description"] == "synthetic test scan"
        with pytest.raises(hdf5.HDF5Error):
            app.preview(_damaged(tmp_path))
    finally:
        app.worker.close()


def _damaged(tmp_path):
    path = tmp_path / "damaged.thz"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(20))
    return str(path)


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_port_never_imports_h5py(where):
    """No module of the port and no line of chip_smoke.py imports h5py (nor,
    for the smoke, JAX or the JAX package)."""
    files = sorted((ROOT / "thz_image_explorer_tpu_torch").rglob("*.py")) \
        if where == "package" else [ROOT / "chip_smoke.py"]
    banned = r"h5py" if where == "package" else r"h5py|jax|thz_image_explorer_tpu\b"
    pattern = re.compile(rf"^\s*(import|from)\s+({banned})")
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.match(line), f"{path.name}:{n}: {line.strip()}"
