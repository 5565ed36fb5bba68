"""Checkpoint and resume for progressive renders and inverse rendering.

Counterpart of ``tpu_pathtracer/utils/checkpoint.py``, with ``torch.save``
of plain dicts in place of orbax. Three states are saved:

  - ``PathState`` (the persistent kernel's lanes), ``frame`` included, which
    keys the Philox draws, so a resumed render continues bit for bit;
  - ``AccumulatorState`` (the wavefront's radiance sum and iteration, which
    keys its draws);
  - ``TrainState``: the parameters, ``optimizer.state_dict()`` and the step.

A directory holds one file per step, ``<step>.pt``, written under a
temporary name and renamed, so a killed write never becomes the latest
step; the newest ``max_to_keep`` steps are kept. Files load with
``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import dataclasses
import os
import re

import torch

from tpu_pathtracer_torch.diff.inverse import TrainState
from tpu_pathtracer_torch.models.progressive import AccumulatorState
from tpu_pathtracer_torch.ops.kernels.persistent import PathState, STATE_FIELDS

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _payload(state) -> dict:
    """The state as a dict of tensors (on the CPU), ints and strings."""
    if isinstance(state, PathState):
        return {"kind": "PathState", "frame": int(state.frame),
                "planes": {f: getattr(state, f).detach().cpu()
                           for f in STATE_FIELDS}}
    if isinstance(state, AccumulatorState):
        return {"kind": "AccumulatorState", "iteration": int(state.iteration),
                "radiance_sum": state.radiance_sum.detach().cpu()}
    if isinstance(state, TrainState):
        return {"kind": "TrainState", "step": int(state.step),
                "params": {k: v.detach().cpu()
                           for k, v in state.params.items()},
                "optimizer": state.optimizer.state_dict()}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def save_state(directory: str, step: int, state, max_to_keep: int = 3
               ) -> None:
    """Snapshot ``state`` (a PathState, AccumulatorState or TrainState) as
    step ``step`` of ``directory``, and keep the newest ``max_to_keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{int(step)}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_payload(state), tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.unlink(os.path.join(directory, f"{old}.pt"))


def latest_step(directory: str) -> int | None:
    """The newest step saved in ``directory``, or None (also when the
    directory does not exist)."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _restore_tensor(name: str, saved: torch.Tensor, like: torch.Tensor
                    ) -> torch.Tensor:
    if saved.shape != like.shape or saved.dtype != like.dtype:
        raise ValueError(
            f"checkpoint field {name}: {tuple(saved.shape)} {saved.dtype}, "
            f"the template has {tuple(like.shape)} {like.dtype}")
    return saved.to(like.device)


def restore_state(directory: str, template, step: int | None = None):
    """Restore the state saved by ``save_state`` at ``step`` (the newest by
    default) onto the template's device, checking each tensor's shape and
    type against the template's. A TrainState is restored into the
    template's own parameter tensors and optimizer, so its Adam keeps
    pointing at them, and the template is returned. Raises
    FileNotFoundError when the directory holds no checkpoint."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    saved = torch.load(os.path.join(directory, f"{int(step)}.pt"),
                       map_location="cpu", weights_only=True)
    kind = type(template).__name__
    if saved["kind"] != kind:
        raise ValueError(f"{directory} step {step} holds a {saved['kind']}, "
                         f"not a {kind}")
    if isinstance(template, PathState):
        return dataclasses.replace(template, frame=saved["frame"], **{
            f: _restore_tensor(f, saved["planes"][f], getattr(template, f))
            for f in STATE_FIELDS})
    if isinstance(template, AccumulatorState):
        return AccumulatorState(
            _restore_tensor("radiance_sum", saved["radiance_sum"],
                            template.radiance_sum), saved["iteration"])
    if set(saved["params"]) != set(template.params):
        raise ValueError(f"checkpoint parameters {sorted(saved['params'])}, "
                         f"the template has {sorted(template.params)}")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(_restore_tensor(k, saved["params"][k], p))
    template.optimizer.load_state_dict(saved["optimizer"])
    template.step = saved["step"]
    return template
