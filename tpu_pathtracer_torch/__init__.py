"""PyTorch and CUDA port of tpu_pathtracer, for NVIDIA Hopper GPUs.

The JAX package ``tpu_pathtracer`` is the reference; this package imports
``torch`` and never ``jax``. It holds sphere and triangle-mesh scenes (built
in Python or read from JSON scene files, the meshes' BVH by the host SAH
builder) rendered through the persistent path-regeneration kernel
(``csrc/persistent.cu``, ``PersistentRenderer``) or the wavefront integrator
(``ProgressiveRenderer``, whose mesh queries run the packet and bin kernels
``csrc/packet.cu`` and ``csrc/bin.cu``); the fused gradient and tangent
kernels, the per-sample kernels and the inverse-rendering trainers;
gradients by autograd through the wavefront; checkpoints, profiling and
debug hooks; the terminal viewer; and the ``render``, ``view`` and
``invert`` CLI.
"""
from tpu_pathtracer_torch.models.camera import Camera, make_camera
from tpu_pathtracer_torch.models.integrator import (
    RenderConfig, render, render_image,
)
from tpu_pathtracer_torch.models.progressive import (
    PersistentRenderer, ProgressiveRenderer,
)
from tpu_pathtracer_torch.models.scene import BUILTIN_SCENES, Scene, make_scene

__all__ = [
    "BUILTIN_SCENES",
    "Camera",
    "PersistentRenderer",
    "ProgressiveRenderer",
    "RenderConfig",
    "Scene",
    "make_camera",
    "make_scene",
    "render",
    "render_image",
]
