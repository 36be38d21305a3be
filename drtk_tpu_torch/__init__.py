"""drtk_tpu_torch: the PyTorch and CUDA port of drtk_tpu.

The differentiable render path of the JAX package, ``rasterize -> render ->
interpolate -> grid_sample -> edge_grad_estimator``, with the same public
signatures and contracts, forward and backward: ``loss.backward()`` through
the public ops reaches the vertices, the uvs and the texture, and
:func:`fit_step` runs one fitting step of the textured pipeline. On CUDA
tensors the rasterizer's resolve (B1), the per-pixel face-row gather (B2),
the pixel-to-face row accumulation (B3) and the texture-gradient scatter
(B4) run as hand-written kernels for Hopper (sm_90a), built with nvcc at
first use; on CPU tensors their plain PyTorch versions run. Nothing is
compiled when the package is imported.
"""

from drtk_tpu_torch.ops import rasterize_cuda as _rasterize_cuda
from drtk_tpu_torch.ops import segment_rows as _segment_rows
from drtk_tpu_torch.ops import window_accum as _window_accum
from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator, edge_grad_image
from drtk_tpu_torch.ops.edge_grad_ref import edge_grad_estimator_ref
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.interpolate import interpolate, interpolate_ref
from drtk_tpu_torch.ops.rasterize import rasterize, rasterize_with_depth
from drtk_tpu_torch.ops.render import render, render_ref
from drtk_tpu_torch.pipeline import fit_step

__all__ = [
    "edge_grad_estimator",
    "edge_grad_estimator_ref",
    "edge_grad_image",
    "fit_step",
    "grid_sample",
    "interpolate",
    "interpolate_ref",
    "kernel_launch_counts",
    "rasterize",
    "rasterize_with_depth",
    "render",
    "render_ref",
    "reset_kernel_launch_counts",
]

__version__ = "0.1.0"


def kernel_launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset, by kernel."""
    return {
        "B1 rasterize": _rasterize_cuda.launches,
        "B2 gather_rows": _segment_rows.launches,
        "B3 scatter_rows": _segment_rows.scatter_launches,
        "B4 window_accum": _window_accum.launches,
    }


def reset_kernel_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _rasterize_cuda.launches = 0
    _segment_rows.launches = 0
    _segment_rows.scatter_launches = 0
    _window_accum.launches = 0
