"""VTK XML export of voxel instances (host only).

Copy of ``thz_image_explorer_tpu/io/vtk.py`` (the reference's
``export_to_vtk``, ``io.rs:59-137``): the 3-D view's voxel instances become
a ``.vtu`` unstructured grid of vertex cells with per-point RGB vectors and
an Opacity scalar, loadable in ParaView. Written by hand (no VTK
dependency) as ascii XML; the same arrays give the same bytes as the JAX
package's writer.
"""

from __future__ import annotations

import numpy as np


def export_to_vtk(
    positions: np.ndarray,  # (N, 3) float
    colors: np.ndarray,  # (N, 4) float rgba
    filename: str,
):
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    colors = np.asarray(colors, np.float64).reshape(-1, 4)
    n = positions.shape[0]
    if colors.shape[0] != n:
        raise ValueError("positions and colors must have the same length")

    connectivity = np.arange(n, dtype=np.int64)
    offsets = np.arange(1, n + 1, dtype=np.int64)
    types = np.full(n, 1, np.uint8)  # VTK_VERTEX

    # stream each DataArray with np.savetxt (one formatted row per point,
    # whitespace-delimited ascii is what VTK parses) instead of building
    # a multi-hundred-MB f-string document in memory: a dense 2M-instance
    # export is ~10^7 per-value Python format calls the old way
    with open(filename, "wb") as f:
        def array(tag, arr, fmt):
            f.write(tag.encode())
            np.savetxt(f, arr, fmt=fmt)
            f.write(b"        </DataArray>\n")

        f.write(f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="1.0" byte_order="BigEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{n}" NumberOfCells="{n}">
      <Points>
""".encode())
        array('        <DataArray type="Float64" NumberOfComponents="3" format="ascii">\n',
              positions, "%.9g")
        f.write(b"      </Points>\n      <Cells>\n")
        array('        <DataArray type="Int64" Name="connectivity" format="ascii">\n',
              connectivity, "%d")
        array('        <DataArray type="Int64" Name="offsets" format="ascii">\n',
              offsets, "%d")
        array('        <DataArray type="UInt8" Name="types" format="ascii">\n',
              types, "%d")
        f.write(b"      </Cells>\n"
                b'      <PointData Vectors="RGB" Scalars="Opacity">\n')
        array('        <DataArray type="Float64" Name="RGB" NumberOfComponents="3" format="ascii">\n',
              colors[:, :3], "%.9g")
        array('        <DataArray type="Float64" Name="Opacity" NumberOfComponents="1" format="ascii">\n',
              colors[:, 3], "%.9g")
        f.write(b"      </PointData>\n"
                b"    </Piece>\n"
                b"  </UnstructuredGrid>\n"
                b"</VTKFile>\n")
