"""Progressive rendering over the persistent path-regeneration step.

Counterpart of ``PersistentRenderer`` in
``tpu_pathtracer/models/progressive.py``: step / render_to / image /
min_samples / iteration / reset / update_camera. The kernel's PathState is
the progressive accumulator: per-pixel radiance sums and completed-sample
counts stay on the device across steps. A mesh scene is packed here for the
kernel's in-kernel walk unless it comes packed.
"""
from __future__ import annotations

import torch

from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.models.integrator import RenderConfig
from tpu_pathtracer_torch.models.scene import Scene, with_packet_mesh
from tpu_pathtracer_torch.ops.kernels import persistent as pk
from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera


class PersistentRenderer:
    """Progressive renderer over ``persistent_step``.

    On a CUDA device every step launches the CUDA kernel; on the CPU it runs
    the plain PyTorch version. ``iteration`` reports
    min-completed-samples // spp: the reference-equivalent frames every pixel
    has finished.
    """

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 seed: int = 0, *, device, budget: int = 32,
                 tile_rows: int = 32, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded rendering (mesh=) is not ported yet (ROADMAP Queue 1 "
                "item 15)")
        self.device = torch.device(device)
        if scene.mesh is not None and scene.mesh_packed is None:
            scene = with_packet_mesh(scene)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.seed = seed
        self.budget = budget
        self.tile_rows = tile_rows
        self._salt = 0
        self._cp = pack_camera(self.camera)
        self.state = self._fresh_state()

    def _fresh_state(self) -> pk.PathState:
        return pk.init_state(self.camera.width, self.camera.height,
                             self.tile_rows, device=self.device)

    def step(self) -> int:
        """Advance all lanes by ``budget`` wavefront iterations; returns the
        number of live ray segments traced."""
        self.state, nrays = pk.persistent_step(
            self.scene, self._cp, (self.seed, self._salt), self.state,
            budget=self.budget, width=self.camera.width,
            height=self.camera.height, max_bounces=self.config.max_bounces,
            rr_start=self.config.rr_start, tile_rows=self.tile_rows,
            use_nee=self.config.use_nee,
        )
        return int(nrays)

    def render_to(self, target_spp: int, max_steps: int = 10_000) -> int:
        """Step until every pixel has >= target_spp completed samples.
        Returns the total live rays traced."""
        total = 0
        for _ in range(max_steps):
            total += self.step()
            if self.min_samples >= target_spp:
                break
        return total

    def image(self) -> torch.Tensor:
        return pk.state_image(self.state, self.camera.width,
                              self.camera.height)

    @property
    def min_samples(self) -> int:
        return int(pk.state_min_samples(self.state, self.camera.width,
                                        self.camera.height))

    @property
    def iteration(self) -> int:
        """Completed reference-equivalent frames (min samples // spp)."""
        return self.min_samples // max(self.config.spp, 1)

    def reset(self) -> None:
        """Restart accumulation; the RNG salt is bumped so the restart draws
        fresh streams rather than replaying the pre-reset paths."""
        self._salt += 1
        self.state = self._fresh_state()

    def update_camera(self, camera: Camera) -> None:
        """Camera motion restarts accumulation (main.cpp:209 semantics)."""
        self.camera = camera.to(self.device)
        self._cp = pack_camera(self.camera)
        self.reset()
