"""Progressive rendering: the wavefront renderer and the persistent one.

Counterpart of ``tpu_pathtracer/models/progressive.py``:

* ``init_state`` / ``step`` / ``image`` / ``reset`` and
  ``ProgressiveRenderer``: the wavefront integrator (``models/integrator.py``)
  renders one frame of ``spp`` samples per step and the state sums the
  frames; a frame's draws are keyed on (seed, iteration). On a CUDA device
  ``ProgressiveRenderer`` packs an unpacked mesh itself (two-pass), so every
  mesh query runs kernels 5 and 6;
* ``PersistentRenderer``: step / render_to / image / min_samples /
  iteration / reset / update_camera over the persistent path-regeneration
  kernel, whose PathState is the accumulator: per-pixel radiance sums and
  completed-sample counts stay on the device across steps. A mesh scene is
  packed here for the kernel's in-kernel walk unless it comes packed;
* ``auto_backend``: the routing of ``cli render --backend auto``.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.models.integrator import RenderConfig, render
from tpu_pathtracer_torch.models.scene import Scene, with_packet_mesh
from tpu_pathtracer_torch.ops.kernels import persistent as pk
from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera
from tpu_pathtracer_torch.utils.errors import not_ported


@dataclasses.dataclass
class AccumulatorState:
    """Progressive state: the sum of the per-iteration mean images, and how
    many were added."""

    radiance_sum: torch.Tensor  # (H, W, 3)
    iteration: int = 0


def init_state(height: int, width: int, *, device="cuda") -> AccumulatorState:
    return AccumulatorState(
        radiance_sum=torch.zeros((height, width, 3), dtype=torch.float32,
                                 device=device))


def reset(state: AccumulatorState) -> AccumulatorState:
    """Restart accumulation (reference Pathtracer::Reset)."""
    return AccumulatorState(torch.zeros_like(state.radiance_sum), 0)


@torch.no_grad()
def step(state: AccumulatorState, scene: Scene, camera: Camera, seed: int,
         config: RenderConfig) -> AccumulatorState:
    """One progressive iteration, with no autograd graph; its draws are
    keyed on the iteration."""
    frame = render(scene, camera, seed, config, iteration=state.iteration)
    return AccumulatorState(state.radiance_sum + frame, state.iteration + 1)


def image(state: AccumulatorState) -> torch.Tensor:
    """The running mean of the accumulated frames."""
    return state.radiance_sum / max(state.iteration, 1)


# Above this many triangles the wavefront with the two-pass binned packet
# traversal is the mesh path, as in the JAX package.
BIG_MESH_TRIS = 10_000


def auto_backend(scene: Scene, device) -> str:
    """``"xla"`` (the wavefront) on the CPU and for meshes of more than
    BIG_MESH_TRIS triangles, else ``"pallas"`` (the persistent kernel). The
    names are the JAX package's, so commands carry over."""
    if torch.device(device).type == "cpu":
        return "xla"
    if scene.mesh is not None and int(scene.mesh.num_tris) > BIG_MESH_TRIS:
        return "xla"
    return "pallas"


class ProgressiveRenderer:
    """Wavefront renderer with the reference app loop's surface: step(),
    image(), iteration, and camera updates that reset the accumulation."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 seed: int = 0, *, device):
        self.device = torch.device(device)
        if (self.device.type == "cuda" and scene.mesh is not None
                and scene.mesh_packed is None):
            scene = with_packet_mesh(scene)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.seed = seed
        self.state = init_state(camera.height, camera.width,
                                device=self.device)

    def step(self) -> None:
        self.state = step(self.state, self.scene, self.camera, self.seed,
                          self.config)

    def image(self) -> torch.Tensor:
        return image(self.state)

    @property
    def iteration(self) -> int:
        return self.state.iteration

    def reset(self) -> None:
        """Restart accumulation (pathtracer.cu:245 semantics)."""
        self.state = reset(self.state)

    def update_camera(self, camera: Camera) -> None:
        """Camera motion restarts accumulation (main.cpp:209 semantics)."""
        self.camera = camera.to(self.device)
        self.reset()


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
            raise not_ported("sharded rendering (mesh=)", "15")
        self.device = torch.device(device)
        if scene.mesh is not None and scene.mesh_packed is None:
            scene = with_packet_mesh(scene, two_pass=False)
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
            use_nee=self.config.use_nee, use_dof=self.camera.use_dof,
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
