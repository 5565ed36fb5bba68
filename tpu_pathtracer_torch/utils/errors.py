"""Errors shared by the port's entry points."""
from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a feature of the JAX package that the port does not
    have yet: ``what`` names it, ``item`` its ROADMAP Queue 1 item."""
    return NotImplementedError(
        f"{what} is not ported to tpu_pathtracer_torch yet "
        f"(ROADMAP Queue 1 item {item})")
