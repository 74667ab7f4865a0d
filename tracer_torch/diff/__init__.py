"""Differentiable (soft) rendering and inverse rendering.

PyTorch counterpart of ``tracer/diff``: the dense soft model
(:mod:`tracer_torch.diff.soft`), its BVH-sparsified forms
(:mod:`tracer_torch.diff.sparse`) and the fit (:mod:`tracer_torch.diff.fit`).
Gradients come from torch autograd.
"""

from tracer_torch.diff.soft import SoftParams, soft_render
from tracer_torch.diff.fit import FitResult, fit_scene

__all__ = ["soft_render", "SoftParams", "fit_scene", "FitResult"]
