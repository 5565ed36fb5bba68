"""Differentiable rendering: inverse rendering on the fused gradient kernel."""
