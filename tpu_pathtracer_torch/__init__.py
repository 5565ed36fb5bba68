"""PyTorch and CUDA port of tpu_pathtracer, for NVIDIA Hopper GPUs.

The JAX package ``tpu_pathtracer`` is the reference; this package imports
``torch`` and never ``jax``. Ported so far: sphere and triangle-mesh scenes
through the persistent path-regeneration kernel (``csrc/persistent.cu``)
and ``PersistentRenderer``; the fused gradient and tangent kernels with the
inverse-rendering trainer; the wavefront integrator and
``ProgressiveRenderer``, whose mesh queries run the packet and bin kernels
(``csrc/packet.cu``, ``csrc/bin.cu``) and which renders textured meshes; and
the ``render`` and ``invert`` CLI.
"""
from tpu_pathtracer_torch.models.integrator import RenderConfig
from tpu_pathtracer_torch.models.progressive import (
    PersistentRenderer, ProgressiveRenderer,
)

__all__ = ["PersistentRenderer", "ProgressiveRenderer", "RenderConfig"]
