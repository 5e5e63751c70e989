"""dotTHz (HDF5) reader/writer and the in-memory scan open.

Port of ``thz_image_explorer_tpu/io/dotthz.py`` (the reference reads the
format with the ``dotthz`` crate, ``io.rs:329-631``). Files are read and
written through the port's own HDF5 module (:mod:`.hdf5`: numpy, zlib and
the standard library), so every file path runs where h5py is missing.

dotTHz group-attribute conventions:

* ``description``/``date``/``time``/``instrument``/``mode``/``thzVer``
  scalar string attrs;
* ``user`` = ``"orcid/name/email/institution"``;
* ``mdDescription`` = comma-separated metadata names, values in attrs
  ``md1``..``mdN``;
* ``dsDescription`` = comma-separated dataset names, data in datasets
  ``ds1``..``dsN``.

Unlike the JAX loader, the pixel grid is never padded to a shape bucket
(that only existed to reuse XLA compiles): ``valid_wh`` is the true grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, load_preprocess, make_cube, resolve_device
from thz_image_explorer_tpu_torch.io import hdf5


@dataclasses.dataclass
class DotthzMetadata:
    """Group-level metadata of a dotTHz file (the ``dotthz`` crate's
    ``DotthzMetaData``)."""

    user: str = ""
    email: str = ""
    orcid: str = ""
    institution: str = ""
    description: str = ""
    md: dict = dataclasses.field(default_factory=dict)
    ds_description: list = dataclasses.field(default_factory=list)
    version: str = "1.00"
    mode: str = ""
    instrument: str = ""
    time: str = ""
    date: str = ""

    def set_rois(self, rois: dict[str, tuple[str, list[tuple[int, int]]]]):
        """Serialize ROIs into metadata entries (``data_thread.rs:104-139``):
        ``"ROI Labels"`` holds the comma-joined labels, ``"ROI <i>"`` holds
        ``[x,y],[x,y],...``. A draft ROI (polygon None) keeps an empty
        label slot so later indices stay aligned."""
        for key in [k for k in self.md if _is_roi_key(k)]:
            del self.md[key]
        if not rois:
            self.md.pop("ROI Labels", None)
            return
        labels = []
        for i, (_uuid, (label, coords)) in enumerate(rois.items()):
            if coords is None:
                labels.append("")
                continue
            labels.append(label)
            self.md[f"ROI {i}"] = ",".join(f"[{x},{y}]" for x, y in coords)
        self.md["ROI Labels"] = ",".join(labels)

    def get_rois(self) -> list[tuple[str, list[tuple[int, int]]]]:
        """Parse ROI entries back into (label, polygon) pairs, tolerant like
        the reference (``data_thread.rs:656-676``): unparsable tokens are
        dropped, a point needs exactly two values, an ROI a non-empty
        polygon; a malformed coordinate never aborts the open."""
        labels = self.md.get("ROI Labels")
        if labels is None:
            return []
        out = []
        for i, label in enumerate(labels.split(",")):
            coords_str = self.md.get(f"ROI {i}")
            if not coords_str:
                continue
            coords = []
            for part in coords_str.split("],"):
                vals = []
                for tok in part.strip().strip("[]").split(","):
                    try:
                        vals.append(float(tok.strip()))
                    except ValueError:
                        continue
                if len(vals) == 2:
                    # the reference casts f64 -> usize (saturating at 0)
                    coords.append((int(max(vals[0], 0.0)), int(max(vals[1], 0.0))))
            if coords:
                out.append((label, coords))
        return out


def _is_roi_key(key: str) -> bool:
    return key.startswith("ROI ") and key[4:].isdigit()


def _attr_str(val) -> str:
    if isinstance(val, bytes):
        return val.decode("utf-8", "replace")
    if isinstance(val, np.ndarray) and val.size == 1:
        return _attr_str(val.reshape(-1)[0])
    if isinstance(val, (np.floating, float)):
        # Rust's Display prints integral floats without ".0" (100.0 ->
        # "100"); width/height are later parsed as integers (io.rs:565)
        f = float(val)
        if f.is_integer() and abs(f) < 1e16:
            return str(int(f))
        return repr(f)
    return str(val)


def read_group_metadata(group) -> DotthzMetadata:
    md = DotthzMetadata()
    attrs = group.attrs
    md.description = _attr_str(attrs.get("description", ""))
    md.date = _attr_str(attrs.get("date", ""))
    md.time = _attr_str(attrs.get("time", ""))
    md.instrument = _attr_str(attrs.get("instrument", ""))
    md.mode = _attr_str(attrs.get("mode", ""))
    md.version = _attr_str(attrs.get("thzVer", "1.00"))
    user = _attr_str(attrs.get("user", ""))
    parts = user.split("/")
    if len(parts) == 4:
        md.orcid, md.user, md.email, md.institution = parts
    else:
        md.user = user
    names = _attr_str(attrs.get("mdDescription", ""))
    if names:
        for i, name in enumerate(n.strip() for n in names.split(",")):
            val = attrs.get(f"md{i + 1}")
            if val is not None:
                md.md[name] = _attr_str(val)
    ds_names = _attr_str(attrs.get("dsDescription", ""))
    if ds_names:
        md.ds_description = [n.strip() for n in ds_names.split(",")]
    return md


def write_group_metadata(group, md: DotthzMetadata):
    group.attrs["description"] = md.description
    group.attrs["date"] = md.date
    group.attrs["time"] = md.time
    group.attrs["instrument"] = md.instrument
    group.attrs["mode"] = md.mode
    group.attrs["thzVer"] = md.version
    group.attrs["user"] = "/".join([md.orcid, md.user, md.email, md.institution])
    group.attrs["mdDescription"] = ",".join(md.md.keys())
    for i, value in enumerate(md.md.values()):
        group.attrs[f"md{i + 1}"] = str(value)
    group.attrs["dsDescription"] = ",".join(md.ds_description)


def clear_group_metadata(group):
    for key in list(group.attrs.keys()):
        del group.attrs[key]


def _first_group(f) -> Optional[str]:
    """First top-level GROUP name; root-level datasets are skipped (the
    reference iterates groups only, ``io.rs:496-509``)."""
    for name in sorted(f.keys()):
        if hdf5.is_group(f[name]):
            return name
    return None


@dataclasses.dataclass
class HostScan:
    """Host-side result of reading a scan: everything but the tensors."""

    time: np.ndarray  #: (T,) float32 time axis
    data: np.ndarray  #: RAW cube (X, Y, T) float32, no DC offset removed
    valid_wh: tuple  #: (X, Y): the port never pads the grid
    metadata: DotthzMetadata = None
    dx: float = None
    dy: float = None
    x_min: float = None
    y_min: float = None

    def preview_image(self) -> np.ndarray:
        """The intensity image in host numpy, for the open's preview:
        per-pixel DC offset removed and squares summed (``io.rs:576-595``),
        expanded as ``sum(d²) - 2·off·sum(d) + T·off²`` so no DC-free copy
        of the cube is made."""
        vw, vh = self.valid_wh
        d = self.data[:vw, :vh]
        off = np.asarray(d[:, :, 0], np.float64)
        ss = np.einsum("xyt,xyt->xy", d, d, dtype=np.float64)
        s = np.einsum("xyt->xy", d, dtype=np.float64)
        n = d.shape[-1]
        return (ss - 2.0 * off * s + n * off * off).astype(np.float32)

    def preview_trace(self, px: int = 0, py: int = 0) -> np.ndarray:
        """One pixel's raw trace with its DC offset removed (the preview's
        pulse plot)."""
        d = self.data[px, py]
        return (d - d[0]).astype(np.float32)


def open_scan_host(path: str) -> HostScan:
    """Read a scan file (``open_scan_from_thz``, ``io.rs:496-631``): first
    group only; first 1-D dataset is time, first 3-D dataset the cube;
    fallback to a 2-D ``[time, signal]`` single pulse as a 1x1 cube."""
    with hdf5.File(path, "r") as f:
        gname = _first_group(f)
        if gname is None:
            raise ValueError(f"no groups in {path}")
        group = f[gname]
        metadata = read_group_metadata(group)

        time = None
        data = None
        ds_names = sorted(group.keys())
        for name in ds_names:
            arr = group[name]
            if hdf5.is_dataset(arr) and arr.ndim == 1:
                time = np.asarray(arr[()], np.float32)
                break
        for name in ds_names:
            arr = group[name]
            if hdf5.is_dataset(arr) and arr.ndim == 3:
                data = np.asarray(arr[()], np.float32)
                break
        dx = dy = None
        if time is None and data is None:
            # single-pulse fallback (io.rs:545-561)
            for name in ds_names:
                arr = group[name]
                if hdf5.is_dataset(arr) and arr.ndim == 2:
                    arr2 = np.asarray(arr[()], np.float32)
                    time = arr2[:, 0]
                    data = arr2[:, 1][None, None, :]
                    dx = dy = 1.0
                    break
        if time is None or data is None:
            raise ValueError(f"no usable datasets in {path}")
    return _host_scan(time, data, metadata, dx, dy)


def open_scan_arrays(time, data, metadata: Optional[DotthzMetadata] = None) -> HostScan:
    """The in-memory counterpart of :func:`open_scan_host`: a ``HostScan``
    from a (T,) time axis and a raw (X, Y, T) cube, with the same metadata
    rules (width/height reshape, dx/dy/x_min/y_min parsing)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 3:
        raise ValueError(f"data must be (X, Y, T), got shape {data.shape}")
    return _host_scan(
        np.asarray(time, np.float32), data, metadata or DotthzMetadata(), None, None
    )


def _host_scan(time, data, metadata, dx, dy) -> HostScan:
    def _parse(key, cast):
        val = metadata.md.get(key)
        if val is None:
            return None
        try:
            return cast(val)
        except ValueError:
            return None

    width = _parse("width", int)
    height = _parse("height", int)
    if width is not None and height is not None and data.shape[:2] != (width, height):
        # metadata wins in the reference when the pixel count agrees
        if width * height == data.shape[0] * data.shape[1]:
            data = data.reshape(width, height, data.shape[2])

    # metadata dx/dy override the single-pulse fallback's 1.0 (io.rs:
    # 598-604 assigns whenever the key exists, None when unparsable)
    def _override(key, current):
        val = metadata.md.get(key)
        if val is None:
            return current
        try:
            return float(val)
        except ValueError:
            return None

    return HostScan(
        time=time,
        data=data,
        valid_wh=(data.shape[0], data.shape[1]),
        metadata=metadata,
        dx=_override("dx [mm]", dx),
        dy=_override("dy [mm]", dy),
        x_min=_parse("x_min [mm]", float),
        y_min=_parse("y_min [mm]", float),
    )


def open_scan(path: str, device=None) -> tuple[ScanCube, np.ndarray, DotthzMetadata]:
    """Open a scan file onto ``device`` (None: the card): ``(cube,
    intensity_image, metadata)``, the host read (:func:`open_scan_host`)
    and the device phase (:func:`finalize_scan`), the image as host numpy
    (``io.rs:576-595``)."""
    host = open_scan_host(path)
    cube, img = finalize_scan(host, resolve_device(device))
    return cube, img.cpu().numpy(), host.metadata


def finalize_scan(host: HostScan, device="cuda") -> tuple[ScanCube, torch.Tensor]:
    """Move a host scan to ``device``: one host-to-device copy of the raw
    cube, DC-offset removal and the intensity image on the device, cube
    assembly. Returns ``(cube, intensity_image)``."""
    raw = torch.as_tensor(host.data, dtype=torch.float32, device=device)
    data, img = load_preprocess(raw)
    del raw
    cube = make_cube(
        host.time, data, dx=host.dx, dy=host.dy,
        x_min=host.x_min, y_min=host.y_min, valid_wh=host.valid_wh,
        device=device,
    )
    return cube, img


def save_scan(path: str, cube: ScanCube, metadata: DotthzMetadata):
    """Write time + cube under an "Image" group (``io.rs:406-433``). Only
    datasets named in ``ds_description`` as ``"time"`` / ``"dataset"`` are
    written, at their declared positions."""
    with hdf5.File(path, "w") as f:
        group = f.create_group("Image")
        write_group_metadata(group, metadata)
        if "time" in metadata.ds_description:
            i = metadata.ds_description.index("time")
            group.create_dataset(f"ds{i + 1}", data=cube.time.cpu().numpy())
        if "dataset" in metadata.ds_description:
            i = metadata.ds_description.index("dataset")
            vw, vh = cube.valid_wh
            group.create_dataset(f"ds{i + 1}", data=cube.data[:vw, :vh].cpu().numpy())


def open_pulse(path: str) -> tuple[np.ndarray, np.ndarray, DotthzMetadata]:
    """Read a single reference pulse: first group, first 2-D dataset, its
    columns ``[time, signal]`` (``io.rs:435-477``)."""
    with hdf5.File(path, "r") as f:
        gname = _first_group(f)
        if gname is None:
            raise ValueError(f"no groups in {path}")
        group = f[gname]
        metadata = read_group_metadata(group)
        for name in sorted(group.keys()):
            ds = group[name]
            if hdf5.is_dataset(ds) and ds.ndim == 2:
                arr = np.asarray(ds[()], np.float32)
                return arr[:, 0], arr[:, 1], metadata
    raise ValueError(f"no 2-D dataset in {path}")


def _resolve_group(f, group_name: Optional[str]) -> str:
    """``"Image"`` when present, else the first group: metadata reads and
    writes target the group :func:`open_scan_host` read from (the
    reference looks up ``"Image"``, ``io.rs:363-380``)."""
    if group_name is not None:
        return group_name
    if "Image" in f and hdf5.is_group(f["Image"]):
        return "Image"
    g = _first_group(f)
    if g is None:
        raise ValueError("no groups in file")
    return g


def load_metadata(path: str, group_name: Optional[str] = None) -> DotthzMetadata:
    """Metadata-only read (``io.rs:329-342``)."""
    with hdf5.File(path, "r") as f:
        return read_group_metadata(f[_resolve_group(f, group_name)])


def update_metadata(path: str, metadata: DotthzMetadata,
                    group_name: Optional[str] = None):
    """Clear and rewrite the metadata in place (``io.rs:363-380``): the
    group gets a new object header at the end of the file, and no dataset
    byte moves (see :mod:`.hdf5`)."""
    with hdf5.File(path, "r+") as f:
        group = f[_resolve_group(f, group_name)]
        clear_group_metadata(group)
        write_group_metadata(group, metadata)
