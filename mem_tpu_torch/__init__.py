"""mem_tpu_torch: the PyTorch + CUDA port of mem_tpu for NVIDIA Hopper (H100).

The JAX package ``mem_tpu`` stays the reference; this package mirrors its
layout and module names so each counterpart is easy to find:

  ops/voxelize_hist.py    <- mem_tpu/ops/voxelize_pallas.py   (kernel K1)
  ops/voxelize.py         <- mem_tpu/ops/voxelize.py
  ops/image_ops.py        <- mem_tpu/ops/image_ops.py          (eval subset)
  ops/attention.py        <- mem_tpu/ops/attention.py          (kernel K2, fwd)
  data/device_pipeline.py <- mem_tpu/data/device_pipeline.py   (eval path)
  models/vit.py, models/classifier.py, models/registry.py
  utils/weights.py        <- mem_tpu/utils/torch_import.py     (key schema)
  utils/checkpoint.py     <- .pth checkpoints (orbax needs jax)
  cli/serve.py            <- mem_tpu/cli/serve.py              (--surface cls)

Every Pallas kernel on the ported path is a CUDA C++ kernel under ``csrc/``,
built for sm_90a at first use (``kernels/build.py``). Each kernel wrapper
takes its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

Importing this package pulls in neither jax nor flax: the only ``mem_tpu``
modules it touches are the lazy ``mem_tpu/__init__.py`` and the stdlib-only
``mem_tpu.utils.config``.
"""

__version__ = "0.1.0"
