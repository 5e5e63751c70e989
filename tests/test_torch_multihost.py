"""The port's per-rank partial open (``parallel/multihost.py``) on the CPU.

Each rank of a mesh reads only its block of pixels: at 2 ranks (1x2) and 4
(2x2), ``open_scan_sharded`` of a ``tests/make_sample.py`` scan equals the
ordinary open (``io/dotthz.open_scan_host`` + ``finalize_scan``) on each
block, a dataset that records the slices read shows each rank read only its
own, the memory-mapped ``.npy`` route (``open_arrays_sharded``, for a
machine without h5py) equals it, pulse files and a 1x1 cube are refused as
the JAX loader refuses them (``tests/test_multihost.py``), and ``device``
None means the card. The blocks of one mesh are computed in this process
(a mesh without a process group); the spawned gloo runs of
``tests/test_torch_parallel.py`` open the same way from each rank.
"""

import h5py
import numpy as np
import pytest
import torch

from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu.io.dotthz import open_scan as jax_open_scan
from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_host
from thz_image_explorer_tpu_torch.parallel import mesh as pm
from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded, open_scan_sharded

MESHES = [(1, 2), (2, 2)]


@pytest.fixture()
def scan(tmp_path):
    p = str(tmp_path / "scan.thzimg")
    t, cube = synthetic_scan(width=30, height=22, n_time=64)
    write_scan_thz(p, t, cube, dx=0.5, dy=0.5)
    return p


class Recording:
    """A dataset that records the slices read from it."""

    def __init__(self, dataset):
        self.dataset, self.reads = dataset, []

    @property
    def shape(self):
        return self.dataset.shape

    def __getitem__(self, key):
        self.reads.append(key)
        return self.dataset[key]


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("explicit_rank", [False, True], ids=["mesh_rank", "rank_argument"])
def test_open_scan_sharded_equals_loader_per_block(scan, shape, explicit_rank):
    """Each rank's block, named by the mesh's own rank or by the ``rank``
    argument of a mesh that is another rank's."""
    whole, img = finalize_scan(open_scan_host(scan), device="cpu")
    for r in range(shape[0] * shape[1]):
        if explicit_rank:
            mesh = pm.Mesh(shape, rank=(r + 1) % (shape[0] * shape[1]))
            cube, bimg, md = open_scan_sharded(scan, mesh, rank=r, device="cpu")
        else:
            mesh = pm.Mesh(shape, rank=r)
            cube, bimg, md = open_scan_sharded(scan, mesh, device="cpu")
        x0, x1, y0, y1 = mesh.block(r, (30, 22))
        assert cube.origin == (x0, y0) and cube.grid == (30, 22)
        assert torch.equal(cube.data, whole.data[x0:x1, y0:y1])
        assert torch.equal(bimg, img[x0:x1, y0:y1])
        assert torch.equal(cube.time, whole.time) and torch.equal(cube.freq, whole.freq)
        assert cube.valid_wh == whole.valid_wh == (30, 22)
        assert (cube.dx, cube.dy, cube.x_min, cube.y_min) == \
            (whole.dx, whole.dy, whole.x_min, whole.y_min)
        assert md.md["width"] == "30"
        assert cube.fft.shape == (x1 - x0, y1 - y0, 33)


def test_sharded_open_matches_jax_loader(scan):
    """The blocks put together are the JAX loader's cube and image (its
    bucket padding cut off)."""
    jcube, jimg, _ = jax_open_scan(scan)
    vw, vh = np.asarray(jcube.valid_wh)
    data = np.zeros((30, 22, 64), np.float32)
    img = np.zeros((30, 22), np.float32)
    for r in range(4):
        cube, bimg, _ = open_scan_sharded(scan, pm.Mesh((2, 2), rank=r), device="cpu")
        (x0, y0), (bx, by) = cube.origin, cube.data.shape[:2]
        data[x0:x0 + bx, y0:y0 + by] = cube.data.numpy()
        img[x0:x0 + bx, y0:y0 + by] = bimg.numpy()
    np.testing.assert_allclose(data, np.asarray(jcube.data)[:vw, :vh], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(img, np.asarray(jimg)[:vw, :vh], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_each_rank_reads_only_its_block(scan, shape):
    with h5py.File(scan, "r") as f:
        group = f["Image"]
        time = group["ds1"][()]
        for r in range(shape[0] * shape[1]):
            mesh = pm.Mesh(shape, rank=r)
            rec = Recording(group["ds2"])
            open_arrays_sharded(time, rec, mesh, device="cpu")
            x0, x1, y0, y1 = mesh.block(r, (30, 22))
            assert rec.reads == [(slice(x0, x1), slice(y0, y1), slice(None))]


def test_open_arrays_sharded_from_memmap_equals_file(scan, tmp_path):
    host = open_scan_host(scan)
    np.save(tmp_path / "cube.npy", host.data)
    mm = np.load(tmp_path / "cube.npy", mmap_mode="r")
    for r in range(4):
        mesh = pm.Mesh((2, 2), rank=r)
        a, ia, _ = open_scan_sharded(scan, mesh, device="cpu")
        b, ib, _ = open_arrays_sharded(host.time, mm, mesh, metadata=host.metadata,
                                       device="cpu")
        assert torch.equal(a.data, b.data) and torch.equal(ia, ib)
        assert (a.origin, a.grid, a.valid_wh, a.dx) == (b.origin, b.grid, b.valid_wh, b.dx)


def test_metadata_reshape_reads_the_whole_cube(scan, tmp_path):
    """width/height metadata that disagree with the stored shape at the
    same pixel count reshape the cube (a full read on every rank)."""
    host = open_scan_host(scan)
    host.metadata.md.update(width="22", height="30")
    rec = Recording(host.data)
    cube, _, _ = open_arrays_sharded(host.time, rec, pm.Mesh((1, 2), rank=1),
                                     metadata=host.metadata, device="cpu")
    assert rec.reads == [()]
    want = host.data.reshape(22, 30, 64)[:, 15:30]
    assert cube.grid == (22, 30) and cube.origin == (0, 15)
    np.testing.assert_array_equal(cube.data.numpy(), want - want[:, :, :1])


def _pulse_file(path):
    with h5py.File(path, "w") as f:
        f.create_group("Measurement").create_dataset("ds1", data=np.zeros((64, 2), np.float32))


def _one_pixel_file(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("Image")
        g.create_dataset("ds1", data=np.arange(64, dtype=np.float32))
        g.create_dataset("ds2", data=np.zeros((1, 1, 64), np.float32))


@pytest.mark.parametrize("make,match", [(_pulse_file, "single-pulse"), (_one_pixel_file, "1x1")])
def test_refuses_what_has_no_pixel_grid(tmp_path, make, match):
    p = str(tmp_path / "f.thz")
    make(p)
    with pytest.raises(ValueError, match="multi-host loader") as err:
        open_scan_sharded(p, pm.Mesh((1, 2)), device="cpu")
    assert match in str(err.value)


def test_device_none_means_the_card(scan, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = open_scan_host(scan)
    mesh = pm.Mesh((1, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_scan_sharded(scan, mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_arrays_sharded(host.time, host.data, mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.init(init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
