#!/usr/bin/env python3
"""Write the dotTHz fixtures of ``tests/data/torch_hdf5/`` with h5py.

    python scripts/make_torch_hdf5_fixtures.py [--seed 0] [--out tests/data/torch_hdf5]

Each file is a scan as the loaders read it (group ``Image``: the dotTHz
metadata attributes, ``ds1`` the time axis, ``ds2`` the cube) stored with
one HDF5 feature that h5py writes and the port's reader
(``thz_image_explorer_tpu_torch/io/hdf5.py``) reads without h5py: the
``libver="latest"`` chunk indexes (extensible array with the unlimited
dimension first and second, v2 B-tree, implicit), the lzf filter with a
chunk stored as it is, files written in SWMR mode (a scan appended line by
line, and one grown past its data), and bool, enum, compound and array
metadata values beside variable-length string notes. ``expected.json``
beside them holds the seed and each file's metadata as the JAX package's
``read_group_metadata`` gives it.

The arrays come from :func:`fixture_arrays`, numpy alone, so that
``chip_smoke.py`` regenerates them from the seed on a machine without h5py
or JAX; only :func:`write` imports those. Run this under
``JAX_PLATFORMS=cpu``. ``tests/test_torch_hdf5_features.py`` fails when the
files no longer match this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_hdf5"
#: the fill value of the grown SWMR file's unwritten lines
GROWN_FILL = -1.5

#: file name -> what it holds
FILES = {
    "earray_unlimited_first.thz": "extensible-array chunk index, cube maxshape (None, 10, 16), "
                                  "300 chunks (the index block, data blocks of the index block "
                                  "and of super blocks)",
    "earray_unlimited_second.thz": "extensible-array chunk index, cube maxshape (10, None, 16) "
                                   "(the unlimited dimension moved to the front), gzip + "
                                   "shuffle + fletcher32",
    "btree2.thz": "v2 B-tree chunk index, cube maxshape (None, None, 16), lzf",
    "implicit.thz": "implicit chunk index (early allocation), cube maxshape (10, 6, 16)",
    "lzf.thz": "lzf, one chunk a scan line, line 3 incompressible noise (stored "
               "raw, its filter mask set)",
    "swmr_lines.thz": "SWMR mode: the cube appended one scan line at a time (extensible array, "
                      "gzip), the time axis too",
    "swmr_grown.thz": "SWMR mode: the cube grown by 3 lines past its data (fill value -1.5), "
                      "v2 B-tree",
    "types.thz": "metadata values of numpy bool, h5py enum, compound (nested), array and "
                 "complex types; variable-length string notes (scalar, 1-D)",
}


def _scan(rng, width, height, n_time):
    t = (np.arange(n_time) * 0.05).astype(np.float32)
    cube = (np.sin(t / 0.7)[None, None, :] * rng.uniform(0.5, 1.0, (width, height, 1))
            + 0.01 * rng.standard_normal((width, height, n_time)) + 0.03).astype(np.float32)
    return t, cube


def fixture_arrays(seed: int = 0) -> dict:
    """{file: {dataset: array}}: every dataset of every fixture, as a reader
    returns it (variable-length strings as ``bytes``)."""
    out = {}
    for k, name in enumerate(FILES):
        rng = np.random.default_rng([seed, k])
        shape = {"earray_unlimited_second.thz": (10, 30, 16), "btree2.thz": (12, 10, 16),
                 "implicit.thz": (8, 6, 16), "lzf.thz": (8, 6, 64)}.get(name, (30, 10, 16))
        t, cube = _scan(rng, *shape)
        if name == "lzf.thz":
            cube = np.round(cube * 8) / np.float32(8)  # a few values: lzf shrinks a line
            cube[3] = rng.standard_normal(cube[3].shape).astype(np.float32)
        if name == "swmr_grown.thz":
            cube = np.concatenate([cube, np.full((3,) + cube.shape[1:], GROWN_FILL, np.float32)])
        out[name] = {"ds1": t, "ds2": cube}
    notes = out["types.thz"]
    notes["note"] = "measured at 21 °C".encode()
    notes["notes"] = np.array([b"first", b"", "zweite é".encode()], object)
    return out


def _metadata(name: str) -> dict:
    """The group's attributes (strings as h5py stores a ``str``)."""
    md = {"width": None, "height": None, "dx [mm]": "0.5", "dy [mm]": "0.5"}
    return {"description": f"fixture {name}", "date": "2026-01-01", "time": "00:00:00",
            "instrument": "synthetic", "mode": "THz-TDS/Transmission", "thzVer": "1.00",
            "user": "0000-0000/fixture/fixture@example.org/lab", "md": md}


def write(out: Path, seed: int):
    """Write every fixture and ``expected.json`` (h5py and the JAX package)."""
    import h5py

    sys.path.insert(0, str(ROOT))
    from thz_image_explorer_tpu.io.dotthz import read_group_metadata

    out.mkdir(parents=True, exist_ok=True)
    arrays = fixture_arrays(seed)
    expected = {"seed": seed, "files": {}}
    for name, what in FILES.items():
        a = arrays[name]
        t, cube = a["ds1"], a["ds2"]
        attrs = _metadata(name)
        md = attrs.pop("md")
        md["width"], md["height"] = str(cube.shape[0]), str(cube.shape[1])
        path = out / name
        swmr = name.startswith("swmr")
        with h5py.File(path, "w", libver="latest") as f:
            g = f.create_group("Image")
            for key, value in attrs.items():
                g.attrs[key] = value
            if name == "types.thz":
                nested = np.dtype([("a", "<f4"), ("b", [("c", "<i2"), ("d", ">f8")]),
                                   ("e", "?"), ("f", "<u2", (2, 3))])
                values = {"flag": np.True_, "off": np.False_,
                          "colour": ("enum", 2, h5py.enum_dtype({"RED": 0, "BLUE": 2}, "i2")),
                          "pair": np.array((1.5, 2), [("a", "<f4"), ("b", "<i4")])[()],
                          "nested": np.ones((), nested)[()], "window": np.arange(3.0),
                          "phasor": np.complex64(1 - 2j)}
                for key, value in values.items():
                    md[key] = None
                    i = list(md).index(key) + 1
                    if isinstance(value, tuple):
                        g.attrs.create(f"md{i}", value[1], dtype=value[2])
                    else:
                        g.attrs[f"md{i}"] = value
                g["note"] = a["note"].decode()
                g["notes"] = np.array([s.decode() for s in a["notes"]],
                                      dtype=h5py.string_dtype())
            g.attrs["mdDescription"] = ",".join(md)
            for i, value in enumerate(md.values()):
                if value is not None:
                    g.attrs[f"md{i + 1}"] = value
            g.attrs["dsDescription"] = "time,dataset"
            if swmr:
                _write_swmr(f, g, name, t, cube)
            else:
                _write_scan(g, name, t, cube)
        with h5py.File(path, "r") as f:
            metadata = dataclasses.asdict(read_group_metadata(f["Image"]))
        expected["files"][name] = {"holds": what, "metadata": metadata}
    (out / "expected.json").write_text(json.dumps(expected, indent=1, ensure_ascii=False) + "\n")


def _write_scan(g, name, t, cube):
    import h5py

    g.create_dataset("ds1", data=t)
    kw = {
        "earray_unlimited_first.thz": dict(chunks=(1, 1, 16), maxshape=(None, 10, 16)),
        "earray_unlimited_second.thz": dict(chunks=(1, 1, 16), maxshape=(10, None, 16),
                                            compression="gzip", shuffle=True,
                                            fletcher32=True),
        "btree2.thz": dict(chunks=(2, 2, 8), maxshape=(None, None, 16),
                           compression="lzf"),
        "lzf.thz": dict(chunks=(1, 6, 64), compression="lzf"),
        "types.thz": dict(chunks=(4, 5, 16), compression="gzip"),
    }.get(name)
    if name == "implicit.thz":
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((3, 4, 8))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        space = h5py.h5s.create_simple(cube.shape, (10, 6, 16))
        d = h5py.h5d.create(g.id, b"ds2", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, cube)
    else:
        g.create_dataset("ds2", data=cube, **kw)


def _write_swmr(f, g, name, t, cube):
    """Datasets made, then SWMR mode started and the lines written one at a
    time, flushed after each (as an acquisition program writes them)."""
    if name == "swmr_lines.thz":
        ds1 = g.create_dataset("ds1", shape=(0,), maxshape=(None,), chunks=(8,), dtype="f4")
        ds2 = g.create_dataset("ds2", shape=(0,) + cube.shape[1:], dtype="f4",
                               maxshape=(None,) + cube.shape[1:], chunks=(1,) + cube.shape[1:],
                               compression="gzip")
        f.swmr_mode = True
        ds1.resize(t.shape)
        ds1[:] = t
        for i, line in enumerate(cube):
            ds2.resize(i + 1, axis=0)
            ds2[i] = line
            ds2.flush()
        return
    n = cube.shape[0] - 3
    g.create_dataset("ds1", data=t)
    ds2 = g.create_dataset("ds2", shape=(0,) + cube.shape[1:], dtype="f4",
                           maxshape=(None, None, cube.shape[2]), chunks=(2, 5, 8),
                           fillvalue=GROWN_FILL)
    f.swmr_mode = True
    for i in range(n):
        ds2.resize(i + 1, axis=0)
        ds2[i] = cube[i]
        ds2.flush()
    ds2.resize(cube.shape[0], axis=0)  # grown past the data: its lines read as the fill value


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args()
    write(args.out, args.seed)
    total = sum(p.stat().st_size for p in args.out.iterdir())
    print(f"{len(FILES)} fixtures and expected.json in {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
