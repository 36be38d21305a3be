"""Barycentric interpolation of vertex attributes (counterpart of
:func:`drtk_tpu.ops.interpolate.interpolate` and ``interpolate_ref``).

Per pixel, the three attribute rows of the rasterized triangle arrive as
one 3*C-float row through :func:`gather_rows_by_index` (kernel B2 on the
card) and are weighted by the barycentric image. Background pixels get the
deterministic -1..1 x/y sweep pattern rather than zeros.

The backward is the JAX package's VJP (``_interpolate_core_bwd``; its
``_geom`` twin differs only in the TPU reduction it selects): the
barycentric gradient is ``sum_c g_c * attr_c`` over the attribute rows,
gathered again through kernel B2, and the attribute gradient is ``bary x g``
summed to face rows through kernel B3, then to vertices with ``index_add_``.
Background pixels contribute nothing: the sweep is a constant.

The sparse interpolation matrices (counterparts of
``drtk_tpu/ops/interpolate.py:388-649``): :func:`interpolation_matrix`
returns ``A`` with one row per pixel (three columns, the face's vertex ids
sorted within the row, and three barycentric values; background rows
masked). Its ``matvec`` is interpolate's forward without the sweep (B2),
its ``rmatvec`` interpolate's attribute VJP (B3, then a fold to vertices).
:func:`interpolation_normal_matrix` returns ``A^T A`` as values over a
topology-only pair structure, built on the host and cached per topology
(:func:`interpolation_normal_structure`); the values
(:func:`interpolation_normal_matrix_values`) sum the nine ``bary_i *
bary_j`` products of each pixel to its face with kernel B3 at K = 9 and
the faces' sums into the structure's slots with ``index_add_``; their
gradient to ``bary_img`` gathers the slots' cotangents back per pixel with
kernel B2.
"""

from __future__ import annotations

import collections
import functools
import operator
import threading
from typing import NamedTuple

import numpy as np
import torch

from drtk_tpu_torch import tracing
from drtk_tpu_torch.ops.math import autocast_f32
from drtk_tpu_torch.ops.rasterize import broadcast_vi
from drtk_tpu_torch.ops.render import _face_table, _pixels_to_verts
from drtk_tpu_torch.ops.segment_rows import gather_rows_by_index, scatter_rows_to_faces

__all__ = [
    "InterpolationMatrix",
    "NormalMatrix",
    "NormalStructure",
    "interpolate",
    "interpolate_ref",
    "interpolation_matrix",
    "interpolation_normal_matrix",
    "interpolation_normal_matrix_values",
    "interpolation_normal_structure",
]

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@functools.lru_cache(maxsize=None)
def _sweep_vector(size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``(arange(size) * 2 + 1) / size - 1`` on ``device``, cached per
    (size, dtype, device), so a forward copies nothing from the host after
    its first call. Callers only read it. Never evicted: a step's CUDA
    graph (:mod:`drtk_tpu_torch.step_graph`) reads it by address, and one
    vector per frame size a process renders is little.

    Built in numpy, in the dtype and op order of the JAX package's sweep,
    and then copied to the device. The JAX package builds it in numpy
    because its compiler may turn the division into a reciprocal-multiply
    (1 ulp off); building it the same way keeps the two bit-exact."""
    if dtype not in _NP_DTYPE:
        raise TypeError(f"interpolate: no background sweep for {dtype}")
    t = _NP_DTYPE[dtype]
    return torch.from_numpy((np.arange(size, dtype=t) * t(2) + t(1)) / t(size) - t(1)).to(device)


def _sweep_pattern(
    height: int, width: int, channels: int, dtype, device, y_offset: int = 0, full_height: int | None = None
) -> torch.Tensor:
    """Background sweep [C, H, W]: channel c holds ``(x*2+1)/W - 1`` when c
    is even and ``(y*2+1)/F - 1`` when c is odd, F the frame's height
    (``full_height``, default ``height``) and y the global row: rows
    ``[y_offset, y_offset + height)`` of the full frame's sweep, bit for
    bit (``drtk_tpu/ops/interpolate.py:81-105``)."""
    device = torch.device(device)
    frame_h = height if full_height is None else full_height
    img_x = _sweep_vector(width, dtype, device)[None, :].expand(height, width)
    img_y = _sweep_vector(frame_h, dtype, device)[y_offset : y_offset + height, None].expand(height, width)
    return torch.stack([img_x if c % 2 == 0 else img_y for c in range(channels)], dim=0)


def _interpolate_fwd_math(vert_attributes, vi, index_img, bary_img, impl="auto", y_offset=0, full_height=None):
    n, h, w = index_img.shape
    c = vert_attributes.shape[-1]
    mask = index_img >= 0
    rows = gather_rows_by_index(_face_table(vert_attributes, vi), index_img, impl)
    attrs = rows.reshape(n, h, w, 3, c)
    bary = bary_img.movedim(1, -1)[..., None]  # [N, H, W, 3, 1]
    ab = attrs * bary
    out = (ab[..., 0, :] + ab[..., 1, :]) + ab[..., 2, :]  # [N, H, W, C]
    out = out.movedim(-1, 1)  # [N, C, H, W]
    sweep = _sweep_pattern(h, w, c, vert_attributes.dtype, vert_attributes.device, y_offset, full_height)[None]
    return torch.where(mask[:, None], out, sweep)


class _Interpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height):
        ctx.save_for_backward(vert_attributes, vi, index_img, bary_img)
        ctx.impl = impl
        return _interpolate_fwd_math(vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height)

    @staticmethod
    def backward(ctx, grad_out):
        """Mirrors ``drtk_tpu/ops/interpolate.py:164-210``."""
        with tracing.span("interpolate_bwd"):
            vert_attributes, vi, index_img, bary_img = ctx.saved_tensors
            n, h, w = index_img.shape
            c = vert_attributes.shape[-1]
            mask = (index_img >= 0).to(grad_out.dtype)
            g = grad_out.movedim(1, -1) * mask[..., None]  # [N, H, W, C]
            grad_attr = grad_bary = None
            if ctx.needs_input_grad[3]:
                rows = gather_rows_by_index(_face_table(vert_attributes, vi), index_img, ctx.impl)
                attrs = rows.reshape(n, h, w, 3, c)
                grad_bary = (g[..., None, :] * attrs).sum(-1).movedim(-1, 1).to(bary_img.dtype)
            if ctx.needs_input_grad[0]:
                bary = bary_img.movedim(1, -1)  # [N, H, W, 3]
                contrib = (bary[..., None] * g[..., None, :]).reshape(n, h, w, 3 * c)
                grad_attr = _pixels_to_verts(contrib, index_img, vi, vert_attributes.shape[1], ctx.impl)
                grad_attr = grad_attr.to(vert_attributes.dtype)
            return grad_attr, None, None, grad_bary, None, None, None


def interpolate(
    vert_attributes: torch.Tensor,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    v_pix: torch.Tensor | None = None,
    impl: str = "auto",
    y_offset: int = 0,
    full_height: int | None = None,
) -> torch.Tensor:
    """Linearly interpolate vertex attributes over rasterized pixels.

    Args:
        vert_attributes: [N, V, C] vertex attributes.
        vi: [N, F, 3] or [F, 3] int32 face indices.
        index_img: [N, H, W] int32 triangle index image (-1 = background).
        bary_img: [N, 3, H, W] barycentric image.
        v_pix: optional [N, V, 3] geometry that produced ``index_img``,
            accepted for parity with the JAX package, which uses it only to
            pick a TPU reduction route for the backward. It has no effect
            here, and its gradient is zero (none is returned), as in JAX.
        impl: "auto" gathers the face rows with kernel B2 on CUDA tensors;
            "plain" uses the plain gather on any device.
        y_offset, full_height: a row-tile viewport, as for
            :func:`~drtk_tpu_torch.ops.rasterize.rasterize`: when the block
            holds rows ``[y_offset, y_offset + H)`` of a
            ``full_height``-row frame, the background sweep takes the global
            rows, so the block equals those rows of the full-frame call bit
            for bit. Without ``full_height`` the block is its own frame and
            ``y_offset`` is ignored, as in the JAX package.

    Returns:
        [N, C, H, W] interpolated image. Background pixels hold the -1..1
        sweep pattern and must be ignored by the caller.
    """
    del v_pix
    vert_attributes = autocast_f32(vert_attributes)
    bary_img = autocast_f32(bary_img)
    if vert_attributes.ndim != 3:
        raise ValueError(
            f"interpolate: expected [N, V, C] attributes, got {tuple(vert_attributes.shape)}"
        )
    vi = broadcast_vi(vi, vert_attributes.shape[0])
    if bary_img.ndim != 4 or bary_img.shape[1] != 3:
        raise ValueError(f"interpolate: expected bary_img [N, 3, H, W], got {tuple(bary_img.shape)}")
    if full_height is None:
        y_offset = 0
    else:
        y_offset, full_height = operator.index(y_offset), operator.index(full_height)
        if y_offset < 0 or y_offset + index_img.shape[1] > full_height:
            raise ValueError(
                f"interpolate: rows [{y_offset}, {y_offset + index_img.shape[1]}) do not lie in a frame of "
                f"{full_height} rows"
            )
    with tracing.span("interpolate"):
        return _Interpolate.apply(vert_attributes, vi, index_img, bary_img, impl, y_offset, full_height)


def interpolate_ref(
    vert_attributes: torch.Tensor,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
) -> torch.Tensor:
    """Float64 reference of :func:`interpolate`.

    Shares no code with the op's forward: per-corner element gathers (not
    the packed face-row gather), the sum formed corner by corner, and the
    sweep assembled by tiling the (x, y) channel pair out to C channels.
    """
    orig_dtype = vert_attributes.dtype
    f64 = torch.float64
    va = vert_attributes.to(f64)
    bary = bary_img.to(f64).movedim(1, -1)  # [N, H, W, 3]
    vi = broadcast_vi(vi, va.shape[0])
    n, h, w = index_img.shape
    c = va.shape[-1]
    dev = va.device

    bidx = torch.arange(n, device=dev)[:, None, None]
    safe = index_img.long().clamp(min=0)
    vi_img = vi.long()[bidx, safe]  # [N, H, W, 3]
    out = torch.zeros((n, h, w, c), dtype=f64, device=dev)
    for k in range(3):
        out = out + va[bidx, vi_img[..., k]] * bary[..., k : k + 1]

    sx = (torch.arange(w, dtype=f64, device=dev) * 2.0 + 1.0) / w - 1.0
    sy = (torch.arange(h, dtype=f64, device=dev) * 2.0 + 1.0) / h - 1.0
    pair = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w)], dim=-1)
    sweep = pair.repeat(1, 1, (c + 1) // 2)[..., :c]
    out = torch.where((index_img != -1)[..., None], out, sweep[None])
    return out.movedim(-1, 1).to(orig_dtype)


# --------------------------------------------------------------------------
# Sparse interpolation matrices
# --------------------------------------------------------------------------


def _pix_vi(vi: torch.Tensor, index_img: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] vertex ids of each pixel's face (face 0's at background,
    indices above F - 1 clamped to it, as JAX's gathers clamp)."""
    n, f_cnt = vi.shape[:2]
    safe = index_img.long().clamp(0, max(f_cnt - 1, 0))
    return vi[torch.arange(n, device=vi.device)[:, None, None], safe]


class _RMatVec(torch.autograd.Function):
    """``A^T y``: per pixel ``bary (x) y`` rows, summed to faces (B3) and
    folded to vertices; its backward is ``A g`` (B2) and the gradient to
    ``bary_img``."""

    @staticmethod
    def forward(ctx, y, bary_img, vi, index_img, num_vertices, impl):
        ctx.save_for_backward(y, bary_img, vi, index_img)
        ctx.impl = impl
        n, h, w = index_img.shape
        c = y.shape[-1]
        bary = bary_img.movedim(1, -1).to(y.dtype)  # [N, H, W, 3]
        rows = (bary[..., :, None] * y.reshape(n, h, w, 1, c)).reshape(n, h, w, 3 * c)
        return _pixels_to_verts(rows, index_img, vi, num_vertices, impl)

    @staticmethod
    def backward(ctx, grad_out):
        y, bary_img, vi, index_img = ctx.saved_tensors
        n, h, w = index_img.shape
        c = y.shape[-1]
        # The rows of grad_out at each pixel's face corners; zero at background.
        rows = gather_rows_by_index(_face_table(grad_out, vi), index_img, ctx.impl).reshape(n, h, w, 3, c)
        grad_y = grad_bary = None
        if ctx.needs_input_grad[0]:
            ab = rows * bary_img.movedim(1, -1)[..., None].to(rows.dtype)
            grad_y = ((ab[..., 0, :] + ab[..., 1, :]) + ab[..., 2, :]).reshape(n, h * w, c)
        if ctx.needs_input_grad[1]:
            grad_bary = (rows * y.reshape(n, h, w, 1, c)).sum(-1).movedim(-1, 1).to(bary_img.dtype)
        return grad_y, grad_bary, None, None, None, None


class InterpolationMatrix(NamedTuple):
    """The pixel-to-vertex matrix ``A`` in a fixed-capacity masked layout
    (``drtk_tpu/ops/interpolate.py:393-440``): every pixel owns a row slot,
    background rows are masked out.

    Attributes:
        cols: [N, H*W, 3] int32 vertex column indices, sorted within each
            row (0 for masked rows).
        vals: [N, H*W, 3] barycentric values in the order of ``cols``
            (zeros for masked rows); differentiable to ``bary_img``.
        row_valid: [N, H*W] bool, True where ``index_img != -1``.
        num_vertices: the number of columns.
        vi, index_img, bary_img, impl: the inputs the matrix was built from;
            :meth:`matvec` and :meth:`rmatvec` run on them through kernels B2
            and B3 ("auto" on CUDA tensors) or their plain versions.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    row_valid: torch.Tensor
    num_vertices: int
    vi: torch.Tensor
    index_img: torch.Tensor
    bary_img: torch.Tensor
    impl: str = "auto"

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x``. x: [N, V, C] -> [N, H*W, C] (zeros at masked rows):
        interpolate's forward with the sweep masked to zero."""
        n, h, w = self.index_img.shape
        out = interpolate(x, self.vi, self.index_img, self.bary_img, impl=self.impl)
        out = torch.where((self.index_img >= 0)[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
        return out.movedim(1, -1).reshape(n, h * w, -1)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """``A.T @ y``. y: [N, H*W, C] -> [N, V, C]; masked rows contribute
        nothing."""
        return _RMatVec.apply(autocast_f32(y), self.bary_img, self.vi, self.index_img, self.num_vertices, self.impl)

    def todense(self) -> torch.Tensor:
        """[N, H*W, V] dense matrix (tests and small problems only)."""
        n, p, _ = self.cols.shape
        nv = self.num_vertices
        rows = torch.arange(n * p, device=self.cols.device).reshape(n, p, 1)
        flat = (rows * nv + self.cols.long()).reshape(-1)
        vals = (self.vals * self.row_valid[..., None]).reshape(-1)
        return self.vals.new_zeros(n * p * nv).index_add(0, flat, vals).reshape(n, p, nv)


def interpolation_matrix(
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    num_vertices: int,
    impl: str = "auto",
) -> InterpolationMatrix:
    """Build the pixel-to-vertex interpolation matrix
    (``drtk_tpu/ops/interpolate.py:443-474``): per pixel the face's three
    vertex ids as columns, sorted with a stable sort (as ``jnp.argsort``),
    and the barycentrics in the same order as values; background rows are
    masked. Gradients flow to ``bary_img`` through ``vals`` and through the
    products.

    Args:
        vi: [N, F, 3] or [F, 3] int32 face indices.
        index_img: [N, H, W] int32 index image (-1 = background).
        bary_img: [N, 3, H, W] barycentrics.
        num_vertices: V, the number of columns.
        impl: "auto" runs the products through kernels B2 and B3 on CUDA
            tensors; "plain" through their plain versions on any device.
    """
    bary_img = autocast_f32(bary_img)
    n, h, w = index_img.shape
    vi = broadcast_vi(vi, n)
    valid = (index_img >= 0).reshape(n, h * w)
    cols, order = torch.sort(_pix_vi(vi, index_img).reshape(n, h * w, 3), dim=-1, stable=True)
    vals = torch.take_along_dim(bary_img.movedim(1, -1).reshape(n, h * w, 3), order.long(), dim=-1)
    cols = torch.where(valid[..., None], cols, torch.zeros((), dtype=cols.dtype, device=cols.device))
    vals = vals * valid[..., None]
    return InterpolationMatrix(cols, vals, valid, int(num_vertices), vi, index_img, bary_img, impl)


class NormalMatrix(NamedTuple):
    """``A.T @ A`` in COO form (``drtk_tpu/ops/interpolate.py:476-509``):
    the topology-only pair structure and per-batch values.

    Attributes:
        rows, cols: [nnz] int32 deduplicated vertex pairs.
        vals: [N, nnz] accumulated ``bary_i * bary_j`` products.
        num_vertices: V.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    num_vertices: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``(A.T A) @ x`` with x: [N, V, C] -> [N, V, C] (plain
        ``index_add``, for small problems and tests)."""
        gathered = x[:, self.cols.long()] * self.vals[..., None]
        return torch.zeros_like(x).index_add(1, self.rows.long(), gathered)

    def todense(self) -> torch.Tensor:
        """[N, V, V] dense matrix (tests and small problems only)."""
        nv = self.num_vertices
        flat = self.rows.long() * nv + self.cols.long()
        return self.vals.new_zeros((self.vals.shape[0], nv * nv)).index_add(1, flat, self.vals).reshape(-1, nv, nv)


class NormalStructure(NamedTuple):
    """Topology-only sparsity structure of ``A.T @ A``
    (``drtk_tpu/ops/interpolate.py:554-569``).

    Attributes:
        rows, cols: [nnz] int32 deduplicated vertex pairs, sorted by
            ``row * V + col``.
        pair_slot: [F, 9] int32, the slot of face pair ``k = i*3 + j``.
        num_vertices: V.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    pair_slot: torch.Tensor
    num_vertices: int


def build_pair_structure(vi: np.ndarray, num_vertices: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The deduplicated vertex-pair structure of ``A.T A`` on the host: the
    keys ``i * V + j`` of every face's 9 directed pairs, sorted and made
    unique (rows, cols [nnz] int32), and each pair's slot (pair_slot [F, 9]
    int32). The same output as ``drtk_tpu/native``'s C++ helper and the JAX
    package's numpy twin; raises ``ValueError`` for a ``vi`` that is not
    [F, 3] or holds an index outside ``[0, V)``, as the C++ helper does.
    """
    vi = np.asarray(vi)
    if vi.ndim != 2 or vi.shape[1] != 3 or not np.issubdtype(vi.dtype, np.integer):
        raise ValueError(f"build_pair_structure: expected [F, 3] integer vi, got {vi.shape} {vi.dtype}")
    num_vertices = int(num_vertices)
    if num_vertices <= 0:
        raise ValueError(f"build_pair_structure: num_vertices must be positive, got {num_vertices}")
    if vi.size and (vi.min() < 0 or vi.max() >= num_vertices):
        raise ValueError(f"build_pair_structure: vertex index outside [0, {num_vertices})")
    f_cnt = vi.shape[0]
    vi64 = vi.astype(np.int64)
    keys = np.repeat(vi64, 3, axis=1) * num_vertices + np.tile(vi64, (1, 3))  # [F, 9], k = i*3 + j
    uniq, inverse = np.unique(keys.reshape(-1), return_inverse=True)
    rows = (uniq // num_vertices).astype(np.int32)
    cols = (uniq % num_vertices).astype(np.int32)
    return rows, cols, inverse.reshape(f_cnt, 9).astype(np.int32)


# Pair structures by (topology bytes, shape, V, device), least recently used
# first; the reference keeps the same LRU (interpolate_module.cpp:36-113).
_STRUCTURE_CACHE: collections.OrderedDict = collections.OrderedDict()
_STRUCTURE_CACHE_MAX = 128
_STRUCTURE_LOCK = threading.Lock()


def interpolation_normal_structure(vi: torch.Tensor, num_vertices: int) -> NormalStructure:
    """Build (or fetch from the LRU cache of 128 topologies) the
    topology-only structure of the normal matrix for ``vi`` ([F, 3], or
    [N, F, 3] with the same topology in every batch element), on ``vi``'s
    device. Built on the host, like the reference's CSR analysis; ``vi`` on
    the card is copied to the host for the cache's key."""
    vi2d = vi if vi.ndim == 2 else vi[0]
    vi_np = vi2d.detach().cpu().numpy()
    key = (vi_np.tobytes(), vi_np.shape, vi_np.dtype.str, int(num_vertices), str(vi.device))
    with _STRUCTURE_LOCK:
        hit = _STRUCTURE_CACHE.get(key)
        if hit is not None:
            _STRUCTURE_CACHE.move_to_end(key)
            return hit
    arrays = build_pair_structure(vi_np, num_vertices)
    hit = NormalStructure(*(torch.from_numpy(a).to(vi.device) for a in arrays), int(num_vertices))
    with _STRUCTURE_LOCK:
        _STRUCTURE_CACHE[key] = hit
        if len(_STRUCTURE_CACHE) > _STRUCTURE_CACHE_MAX:
            _STRUCTURE_CACHE.popitem(last=False)
    return hit


class _NormalValues(torch.autograd.Function):
    """The nine products per pixel, summed to faces (B3 at K = 9) and the
    faces' sums into the structure's slots; backward by B2 and the product
    rule."""

    @staticmethod
    def forward(ctx, bary_img, pair_slot, index_img, nnz, impl):
        ctx.save_for_backward(bary_img, pair_slot, index_img)
        ctx.impl = impl
        n, h, w = index_img.shape
        f_cnt = pair_slot.shape[0]
        bary = bary_img.movedim(1, -1)  # [N, H, W, 3]
        prod = (bary[..., :, None] * bary[..., None, :]).reshape(n, h, w, 9)  # k = i*3 + j
        per_face = scatter_rows_to_faces(prod, index_img, f_cnt, impl)  # background dropped
        out = bary_img.new_zeros((n, nnz))
        return out.index_add_(1, pair_slot.reshape(-1).long(), per_face.reshape(n, f_cnt * 9))

    @staticmethod
    def backward(ctx, grad_out):
        """``d/d bary_i = sum_j (g_ij + g_ji) bary_j``, g the slots'
        cotangents at the pixel's face; zero at background."""
        bary_img, pair_slot, index_img = ctx.saved_tensors
        n, h, w = index_img.shape
        g_face = grad_out[:, pair_slot.long()].reshape(n, -1, 9).contiguous()
        g = gather_rows_by_index(g_face, index_img, ctx.impl).reshape(n, h, w, 3, 3)
        bary = bary_img.movedim(1, -1)  # [N, H, W, 3]
        grad = ((g + g.transpose(-1, -2)) * bary[..., None, :]).sum(-1)  # [N, H, W, 3]
        return grad.movedim(-1, 1).to(bary_img.dtype), None, None, None, None


def interpolation_normal_matrix_values(
    structure: NormalStructure,
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Value-only recompute of the normal matrix against a cached structure
    (``drtk_tpu/ops/interpolate.py:572-624``): the nine ``bary_i *
    bary_j`` products of each foreground pixel summed into the structure's
    slots; differentiable with respect to ``bary_img``.

    ``vi`` is accepted for parity with the JAX package (which takes only its
    mask from it); the structure's ``pair_slot`` carries the topology.
    ``impl`` as for :func:`interpolation_matrix`.

    Returns [N, nnz] values aligned with ``structure.rows/cols``.
    """
    del vi
    bary_img = autocast_f32(bary_img)
    pair_slot = structure.pair_slot.to(index_img.device)
    return _NormalValues.apply(bary_img, pair_slot, index_img, int(structure.rows.shape[0]), impl)


def interpolation_normal_matrix(
    vi: torch.Tensor,
    index_img: torch.Tensor,
    bary_img: torch.Tensor,
    num_vertices: int,
    impl: str = "auto",
) -> NormalMatrix:
    """Assemble ``A.T @ A`` directly (``drtk_tpu/ops/interpolate.py:
    627-649``): the structure from :func:`interpolation_normal_structure`,
    the values from :func:`interpolation_normal_matrix_values`. ``vi`` is
    [F, 3] or [N, F, 3] with the same topology in every batch element."""
    structure = interpolation_normal_structure(vi, int(num_vertices))
    vals = interpolation_normal_matrix_values(structure, vi, index_img, bary_img, impl)
    return NormalMatrix(structure.rows, structure.cols, vals, int(num_vertices))
