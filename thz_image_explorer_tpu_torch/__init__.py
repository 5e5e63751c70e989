"""THz Image Explorer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``thz_image_explorer_tpu`` (which stays the
reference the port is tested against). Layout mirrors it module by module:

``data``      the :class:`~thz_image_explorer_tpu_torch.data.ScanCube`
              dataclass of tensors, frequency axis, load preprocessing
``io``        dotTHz (HDF5) reader/writer, the in-memory open, the
              PSF ``.npz`` codec and the VTU export
``models``    the frequency-resolved PSF model (splines + hybrid fits)
``ops``       windows, band-passes, tilt compensation, FFT/unwrap,
              scaling, intensity, ROI masks, optical properties, the
              PSF tool's FIR band filtering, the one-pass spectral
              reduction (``ops/specred.py`` + ``csrc/specred.cu``), the
              FIR bank and the frequency-resolved Richardson-Lucy
              deconvolution (``ops/deconvolution.py``, its kernels
              ``ops/rlsep.py`` + ``csrc/rlsep_cluster.cu`` and
              ``csrc/rlsep.cu``), the 3-D voxel view (``ops/voxel.py``,
              its kernel ``ops/envelope.py`` + ``csrc/envelope.cu``) and
              the general 2-D Richardson-Lucy kernels (``ops/rl2d.py`` +
              ``csrc/rl2d_cluster.cu`` and ``csrc/rl2d.cu``)
``pipeline``  stage protocol, filters, the per-stage executor, publish
              and the :class:`~thz_image_explorer_tpu_torch.pipeline.
              explorer.Explorer` command facade
``parallel``  the pixel-grid mesh over ``torch.distributed`` ranks, the
              sharded update step and the per-rank partial open
``psf_tool``  knife-edge measurements -> fitted PSF model -> ``.npz``
``web``       the web shell: a page, its state poll and commands through
              the :class:`~thz_image_explorer_tpu_torch.pipeline.worker.
              ExplorerWorker`; ``cli`` the command-line shell
              (``python -m thz_image_explorer_tpu_torch``); ``viz`` and
              ``utils`` their host helpers
``convert``   JAX-side state (numpy leaves, PSF arrays, filter
              parameters, knife-edge measurements and fits) -> the
              port's, for the tests

Devices are explicit: every entry point takes a ``device`` and defaults to
``"cuda"``; nothing falls back to the CPU on its own.

The package never imports ``jax`` nor anything of ``thz_image_explorer_tpu``.
"""

import torch

__version__ = "0.1.0"

# Full-f32 numerics everywhere: the masked-mean products feed
# optical-property phase differences, and TF32 keeps only ~3 decimal
# digits. Matmul TF32 is already off by default; cuDNN TF32 is not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
