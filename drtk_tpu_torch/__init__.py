"""drtk_tpu_torch: the PyTorch and CUDA port of drtk_tpu.

The differentiable render path of the JAX package, ``transform ->
rasterize -> render -> interpolate -> grid_sample -> edge_grad_estimator``,
with the same public signatures and contracts, forward and backward:
``loss.backward()`` through the public ops reaches the world-space
vertices, the cameras, the uvs and the texture; :func:`fit_step` runs one
fitting step of the textured pipeline and :func:`inverse8_step` one step of
the multi-view inverse-rendering fit. Row-tile viewports of rasterize,
render and interpolate, mipmapped anisotropic shading
(:func:`mipmap_grid_sample`), Multi-Sphere Image backgrounds (:func:`msi`)
and row banding (:func:`map_row_bands`, :func:`edge_grad_estimator_banded`)
make up :func:`avatar4k_step`, one step of the 4K avatar fit. Lens
distortion (radial-tangential, fisheye, Fisheye62) in :func:`transform`,
mesh geometry in :mod:`drtk_tpu_torch.utils`, the analytic screen-space uv
Jacobian (:func:`screen_space_uv_derivative`, pinhole or through a Fisheye62
lens; the other lenses raise there) that drives mipmap shading in
:func:`render_mipmap_multiview` (fitted by :func:`mipviews_step`),
:func:`grid_scatter` (the transpose of ``grid_sample``) and the alias-free
resampling filters of ``filter2d``
complete the JAX package's single-device API, with the sparse
interpolation matrices (:func:`interpolation_matrix`,
:func:`interpolation_normal_matrix` over a cached pair structure). The
multi-device layer is :mod:`drtk_tpu_torch.parallel` (``sharding``,
``spmd``, ``multihost``): a frame's rows and cameras over the ranks of a
``torch.distributed`` mesh, edge_grad's halo row passed between them.
On CUDA tensors the rasterizer's
resolve (B1), its wireframe resolve (B5), the per-pixel face-row gather
(B2), the pixel-to-face row accumulation (B3), the texture-gradient
scatter, which is also grid_scatter's splat (B4), and edge_grad's whole
backward (E1) run as hand-written kernels for Hopper (sm_90a), built with
nvcc at first use; on CPU tensors their plain PyTorch versions run.
Nothing is compiled when the package is imported. :mod:`drtk_tpu_torch.tracing`
records the ops' and steps' spans, and the collectives' bytes, while a
caller has a tracer entered; it always counts the kernels' launches
(:func:`kernel_launch_counts`) and how the steps that replay as a CUDA
graph ran (:func:`step_graph_counts`, :mod:`drtk_tpu_torch.step_graph`).
"""

from drtk_tpu_torch.ops.edge_grad import edge_grad_estimator, edge_grad_image
from drtk_tpu_torch.ops.edge_grad_ref import edge_grad_estimator_ref
from drtk_tpu_torch import utils
from drtk_tpu_torch.ops.filter2d import (
    FilterOptions,
    FilterType,
    downsample,
    filter,
    low_pass_filter,
    make_resampling_kernel,
    resample_filter,
    upsample,
)
from drtk_tpu_torch.ops.grid_sample import grid_sample
from drtk_tpu_torch.ops.grid_scatter import grid_scatter, grid_scatter_ref
from drtk_tpu_torch.ops.interpolate import (
    InterpolationMatrix,
    NormalMatrix,
    NormalStructure,
    interpolate,
    interpolate_ref,
    interpolation_matrix,
    interpolation_normal_matrix,
    interpolation_normal_matrix_values,
    interpolation_normal_structure,
)
from drtk_tpu_torch.ops.mipmap_grid_sample import mipmap_grid_sample, mipmap_grid_sample_ref
from drtk_tpu_torch.ops.msi import msi
from drtk_tpu_torch.ops.rasterize import rasterize, rasterize_with_depth
from drtk_tpu_torch.ops.render import render, render_ref
from drtk_tpu_torch.parallel.banded import edge_grad_estimator_banded, map_row_bands
from drtk_tpu_torch.pipeline import (
    avatar4k_step,
    fit_step,
    inverse8_step,
    mipviews_step,
    render_mipmap_multiview,
    render_multiview,
)
from drtk_tpu_torch.screen_space_uv_derivative import screen_space_uv_derivative
from drtk_tpu_torch.transform import transform, transform_with_v_cam
from drtk_tpu_torch.tracing import kernel_launch_counts, reset_kernel_launch_counts, step_graph_counts

__all__ = [
    "FilterOptions",
    "FilterType",
    "InterpolationMatrix",
    "NormalMatrix",
    "NormalStructure",
    "avatar4k_step",
    "downsample",
    "edge_grad_estimator",
    "edge_grad_estimator_banded",
    "edge_grad_estimator_ref",
    "edge_grad_image",
    "filter",
    "fit_step",
    "grid_sample",
    "grid_scatter",
    "grid_scatter_ref",
    "interpolate",
    "interpolate_ref",
    "interpolation_matrix",
    "interpolation_normal_matrix",
    "interpolation_normal_matrix_values",
    "interpolation_normal_structure",
    "inverse8_step",
    "kernel_launch_counts",
    "low_pass_filter",
    "make_resampling_kernel",
    "map_row_bands",
    "mipmap_grid_sample",
    "mipmap_grid_sample_ref",
    "mipviews_step",
    "msi",
    "rasterize",
    "rasterize_with_depth",
    "render",
    "render_mipmap_multiview",
    "render_multiview",
    "render_ref",
    "resample_filter",
    "reset_kernel_launch_counts",
    "screen_space_uv_derivative",
    "step_graph_counts",
    "transform",
    "transform_with_v_cam",
    "upsample",
    "utils",
]

__version__ = "0.1.0"

