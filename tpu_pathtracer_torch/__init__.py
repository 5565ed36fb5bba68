"""PyTorch and CUDA port of tpu_pathtracer, for NVIDIA Hopper GPUs.

The JAX package ``tpu_pathtracer`` is the reference; this package imports
``torch`` and never ``jax``. Ported so far: sphere scenes through the
persistent path-regeneration kernel (``ops/kernels/persistent.py`` and
``csrc/persistent.cu``), the progressive renderer and the ``render`` CLI.
"""
from tpu_pathtracer_torch.models.integrator import RenderConfig
from tpu_pathtracer_torch.models.progressive import PersistentRenderer

__all__ = ["PersistentRenderer", "RenderConfig"]
