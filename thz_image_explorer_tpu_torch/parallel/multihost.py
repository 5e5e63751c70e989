"""Per-rank partial scan reads: each rank opens only its block of pixels.

Port of ``thz_image_explorer_tpu/parallel/multihost.py``. Loading the whole
cube in every process and then cutting it would read the whole scan once
per rank. Instead each rank reads only its :meth:`Mesh.block
<thz_image_explorer_tpu_torch.parallel.mesh.Mesh.block>` out of the dotTHz
file (``dset[x0:x1, y0:y1, :]``: the file on a shared filesystem is the
distribution medium) and runs the port's load preprocessing on it, the DC
offset and the intensity image, which are per pixel. The time and
frequency axes and ``valid_wh`` are the same on every rank.

The loader's rules are the JAX package's (the reference's ``io.rs:
496-631``): first group, first 1-D dataset in sorted order is the time, the
first 3-D dataset the cube; single-pulse files and a 1x1 cube have no pixel
grid to split and are refused; ``width``/``height`` metadata that disagree
with the stored shape at the same pixel count reshape the cube, which
needs a full read on every rank.

:func:`open_scan_sharded` reads the file through the port's own HDF5
module (:mod:`..io.hdf5`), whose slice of a contiguous dataset reads only
its bytes and of a chunked one only the chunks it touches; the block read
takes any array with numpy slicing, so :func:`open_arrays_sharded` also
serves a memory-mapped ``.npy``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import (
    ScanCube,
    load_preprocess,
    make_cube,
    resolve_device,
)
from thz_image_explorer_tpu_torch.io import hdf5
from thz_image_explorer_tpu_torch.io.dotthz import (
    DotthzMetadata,
    _first_group,
    read_group_metadata,
)
from thz_image_explorer_tpu_torch.parallel.mesh import Mesh

_REFUSE_PULSE = ("multi-host loader needs a 1-D time and a 3-D cube dataset "
                 "(single-pulse files go through open_scan): {}")
_REFUSE_1X1 = "multi-host loader needs a real pixel grid (got a 1x1 cube — use open_scan): {}"


def _locate_datasets(group) -> tuple[Optional[str], Optional[str]]:
    """First 1-D dataset name (time) and first 3-D dataset name (cube) in
    sorted order (``io.rs:520-543``)."""
    time_name = data_name = None
    for name in sorted(group.keys()):
        d = group[name]
        if not hdf5.is_dataset(d):
            continue
        if time_name is None and d.ndim == 1:
            time_name = name
        if data_name is None and d.ndim == 3:
            data_name = name
    return time_name, data_name


def open_scan_sharded(path: str, mesh: Mesh, rank: Optional[int] = None, device=None
                      ) -> tuple[ScanCube, torch.Tensor, DotthzMetadata]:
    """Open ``rank``'s block (this process's for None) of the scan at
    ``path``: ``(cube, intensity image, metadata)``, the cube and image of
    the block (see :func:`open_arrays_sharded`). ``device`` None means the
    card."""
    device = resolve_device(device)
    with hdf5.File(path, "r") as f:
        gname = _first_group(f)
        if gname is None:
            raise ValueError(f"no groups in {path}")
        group = f[gname]
        metadata = read_group_metadata(group)
        time_name, data_name = _locate_datasets(group)
        if time_name is None or data_name is None:
            raise ValueError(_REFUSE_PULSE.format(path))
        return open_arrays_sharded(group[time_name][()], group[data_name], mesh, rank,
                                   metadata, device, where=path)


def open_arrays_sharded(time, dataset, mesh: Mesh, rank: Optional[int] = None,
                        metadata: Optional[DotthzMetadata] = None, device=None,
                        where: str = "arrays"
                        ) -> tuple[ScanCube, torch.Tensor, DotthzMetadata]:
    """``rank``'s block of a scan given as a (T,) time axis and a raw
    (X, Y, T) ``dataset`` that supports numpy slicing (an :mod:`..io.hdf5`
    dataset, a ``np.memmap``, an array): ``(cube, intensity image, metadata)``.

    Reads ``dataset[x0:x1, y0:y1, :]`` of :meth:`Mesh.block` and nothing
    else (the whole dataset only when the metadata reshape it);
    the block's DC offset is removed and its intensity image computed on
    ``device`` (None means the card). The cube keeps the scan's
    ``valid_wh`` and records its ``origin`` and ``grid``."""
    device = resolve_device(device)
    metadata = metadata or DotthzMetadata()
    if len(dataset.shape) != 3:
        raise ValueError(_REFUSE_PULSE.format(where))
    vw, vh, n_time = dataset.shape
    if vw * vh == 1:
        raise ValueError(_REFUSE_1X1.format(where))
    width, height = _md(metadata, "width", int), _md(metadata, "height", int)
    if width is not None and height is not None and (vw, vh) != (width, height) \
            and width * height == vw * vh:
        # the stored rows no longer match the pixel grid: a partial read is
        # impossible, so every rank reads the whole cube (rare)
        dataset = np.asarray(dataset[()], np.float32).reshape(width, height, n_time)
        vw, vh = width, height
    x0, x1, y0, y1 = mesh.block(rank, (vw, vh))
    block = np.array(dataset[x0:x1, y0:y1, :], np.float32)
    data, img = load_preprocess(torch.as_tensor(block, device=device))
    cube = make_cube(np.asarray(time, np.float32), data, dx=_md(metadata, "dx [mm]", float),
                     dy=_md(metadata, "dy [mm]", float), x_min=_md(metadata, "x_min [mm]", float),
                     y_min=_md(metadata, "y_min [mm]", float), valid_wh=(vw, vh), device=device)
    return cube.replace(origin=(x0, y0), grid=(vw, vh)), img, metadata


def _md(metadata: DotthzMetadata, key: str, cast):
    """A metadata value parsed by ``cast``; None when missing or unparsable."""
    try:
        return cast(metadata.md[key])
    except (KeyError, ValueError):
        return None
