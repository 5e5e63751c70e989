"""THz Image Explorer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``thz_image_explorer_tpu`` (which stays the
reference the port is tested against). Layout mirrors it module by module:

``data``      the :class:`~thz_image_explorer_tpu_torch.data.ScanCube`
              dataclass of tensors, frequency axis, load preprocessing
``io``        dotTHz (HDF5) reader/writer and the in-memory open
``ops``       windows, band-passes, FFT/unwrap, scaling, intensity,
              ROI masks, optical properties, and the one-pass spectral
              reduction (``ops/specred.py`` + ``csrc/specred.cu``)
``pipeline``  stage protocol, filters, the per-stage executor, publish
              and the :class:`~thz_image_explorer_tpu_torch.pipeline.
              explorer.Explorer` command facade
``convert``   JAX-state (numpy leaves) -> port tensors, for the tests

Devices are explicit: every entry point takes a ``device`` and defaults to
``"cuda"``; nothing falls back to the CPU on its own.

The package never imports ``jax`` nor anything of ``thz_image_explorer_tpu``.
"""

import torch

# Full-f32 numerics everywhere: the masked-mean products feed
# optical-property phase differences, and TF32 keeps only ~3 decimal
# digits. Matmul TF32 is already off by default; cuDNN TF32 is not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
