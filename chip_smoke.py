"""Drive drtk_tpu_torch's render paths and fitting steps on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only   # the row-sharded step alone
    python3 chip_smoke.py --render-only    # kernel R1 alone, at the benchmark's sizes

Builds the eight CUDA kernels from the sources in this checkout, holds each
one against its plain PyTorch version on the card, then drives the paths a
user calls, each with the kernel launch counts reset just before it and
checked just after:

- on the repository's flagship scene (``textured``: 1024x1024 pixels, a
  161x161-vertex grid of 51,200 triangles, per-vertex uvs, a 3x512x512
  texture), the forward render and the fitting step (forward and backward,
  with gradients to the vertices, the uvs and the texture);
- on the ``inverse8`` scene of ``bench.py`` (8 pinhole cameras of 512x512
  around a world-space grid of 12,800 triangles, a 3x256x256 texture), the
  wireframe render of every view through ``transform`` (kernel B5) and the
  multi-view training step (``transform`` through the textured pipeline
  with a silhouette, gradients to the world vertices and the texture, an
  Adam update);
- on the ``avatar4k`` scene of ``bench.py`` (a 4096x4096 frame of a
  226x226-vertex grid, 101,250 triangles, in 4 row bands recomputed in the
  backward, mipmapped shading from a 3x512^2..3x64^2 pyramid, an MSI
  background on 256^2 rays), the training step (gradients to the vertices,
  the pyramid and the MSI texture, an Adam update), with B1 under the
  viewport, B2, E1 (the banded edge_grad backward's band 0) and B3 (that
  band's bary x g rows, from the plain stencil) held against their plain
  versions and M1 (the mipmap, forward and backward) against the
  composite on the step's own band-0 inputs, the bands against the full
  frame and the band recompute against none;
- on the inverse8 scene again, the training step through a lens (each
  camera a Fisheye62 lens with its fov estimated once before the steps;
  then a per-view list of pinhole, radial-tangential and fisheye lenses),
  and the 8 views shaded with mipmaps as ``examples/04`` shades
  (``render_mipmap_multiview``: the analytic uv Jacobian driving
  ``mipmap_grid_sample`` from a 4-level pyramid of the texture), forward
  and backward, each against the same path through the plain versions, M1
  against the composite on the views' own inputs;
- ``grid_scatter`` of the textured scene's 1024^2 render through its uv
  image into a 3x512^2 texture (bilinear/border, bicubic/zeros), its one B4
  launch per forward held against the plain version on the same taps and
  the output against ``grid_scatter_ref`` in float64; and ``filter2d``
  (Kaiser down and up by 2, a Lanczos low-pass) on the textured scene at
  2048^2, with cuDNN's TF32 allowed, against ``filter2d_ref`` in float64;
- the sparse interpolation matrices on the textured frame and on the
  inverse8 step's views: A and A^T A, matvec (B2), rmatvec (B3), the
  normal values (B3 at K = 9) and their gradient (B2), held against
  ``interpolate``, its VJP, ``rmatvec(matvec(x))`` and the plain versions;
- the row-sharded step (``drtk_tpu_torch.parallel.spmd``) on the textured
  scene: 4 ranks spawned once (NCCL with a card each where there are 4
  cards, else Gloo with every rank on this card), meshes (1, 4), (2, 2)
  with 2 cameras and (1, 2) over two of the ranks, an Adam step on v, vt
  and tex; each rank's launches (B1-B4), its gathered frame against one
  process's bit for bit, its gradients against ``fit_step``'s and its E1
  launch against the plain version.

The face-row gather (B2), the pixel-to-face accumulation (B3) and the
texture-gradient scatter (B4) are held against their plain versions on the
index images (B4: the taps) of the textured scene and of the inverse8
step's 8 views, B3 and B4 with the global atomics their designs imply
(modeled from the index image or the taps, not counted on the card); triangle
rasterization (B1), bit for bit, on the entry and textured scenes and on
the views of the inverse8 step; wireframe rasterization (B5), bit for bit,
on the entry, textured and inverse8 scenes and on a scene of edges within
ulps of the diamonds' reach (``near_miss_scene``), with the edge tests its
rejects leave (modeled from the packed rows); and row-tile viewports of B1
and B5 against the full frame; and the edge_grad backward (E1), in verts
mode (index image to vertex gradient) and image mode at max_dp_dr 1e4 and
0, on the launch arguments each path makes: the fitting step, the
inverse8 step and its two lens steps, the mipmapped views, the avatar4k
step's band 0 with its halo row, each row-sharded rank (verts mode), the
entry scene (where atomics meet) and the near-miss scene (one input also
in float64), its nonzero vertices (pixels) equal to the plain version's
and its values within 1e-5 (float64: 1e-12) of their largest magnitude;
the edge_grad backward alone, full frame and banded, under torch.profiler:
E1 and the output's zeros, no B3, no ``index_add_``; and render (R1), its
forward bit for bit and its backward within 1e-5 of the plain version's
largest magnitude, on inverse8's frame (8 x 1024^2) and a card's block of
the rows4 cell (8 x 1024 x 4096, y_offset 1024), with the global atomics
its design implies (modeled from the index image). Each path's peak
device memory is printed. Times come from CUDA events: a kernel's ``ms`` (and
``plain_ms``, ``library_ms``) from back-to-back calls, which count the
host's time per call when it is the longer; ``device_ms`` (and
``library_device_ms``) from replays of a CUDA graph of 20 calls, the time
on the device alone. Every earlier line of
output is a JSON object (or the raw nvidia-smi line); the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
then exits non-zero without that line. It exits non-zero at once when CUDA
is absent or the package is not beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# TF32 off for matrix products and cuDNN: no kernel path should use either,
# and with both off a stray library call cannot silently round f32 operands
# to 10 mantissa bits in the comparisons below. The filter2d phase, whose
# convolutions are cuDNN's, turns cuDNN's TF32 back on (PyTorch's default):
# the op must keep float32 itself.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 1024  # the textured configuration (bench.py: bench_textured)
GN = 161  # 161x161 vertices -> 51,200 triangles
ENTRY_HW = 256  # the entry() scene: 96 random vertices, 128 large triangles
WARMUP, STEPS = 3, 25
PROFILED_STEPS = 5
FLOPS_PER_TEST = 17  # per pixel centre tested by B1: 3 edges x (2 mul + 2 add), di 3 mul + 2 add
INV_HW, INV_GN, INV_VIEWS = 512, 81, 8  # the inverse8 configuration (bench.py: bench_inverse8)
# B5's bound: what the function needs, whatever the design: three edge functions per window pixel
# (3 x (2 mul + 2 add)), and the rows, meta and ends read once and 8 bytes of depth and index written per
# output pixel. The kernel's own key buffer (8 bytes per pixel set, updated and read back by its unpack)
# is not in the bound; its bytes are printed beside it (key_buffer_bytes, key_buffer_ms).
LINE_FLOOR_FLOPS_PER_TEST, LINE_BYTES_PER_PIXEL, LINE_KEY_BYTES_PER_PIXEL = 12, 8, 3 * 8
# The first B5 design's model of the full test, printed beside it (full_test_ops_ms), for comparison with
# earlier runs that used it as the bound: per pixel 3 edges x 4, then clip,
# renormalise and di (3 mul, 3 x 2 clamp, 2 add, 3 div, 3 mul, 2 add); per visible edge its line (2 sub,
# 2 mul, 1 sub) and four diamond sides of 16 (a2, b2: 2 sub; c2, d: 2 x (2 mul + 1 sub); cx, cy: 2 x
# (2 mul + 1 sub + 1 div)), each division counted once.
LINE_FLOPS_PER_TEST, LINE_FLOPS_PER_EDGE = 12 + 19, 5 + 4 * 16
CAMS = ("campos", "camrot", "focal", "princpt")
# The avatar4k configuration (bench.py: bench_avatar4k, BASELINE config 5): 4096^2, a 226x226-vertex grid
# (101,250 triangles), 4 row bands, a 256^2 MSI ray grid; 2 warm-up steps, 5 timed, 2 profiled.
AV_HW, AV_GN, AV_BH, AV_BANDS = 4096, 226, 256, 4
AV_WARMUP, AV_STEPS, AV_PROFILED = 2, 5, 2
# The per-view lens list of the lens list step, cycled over the inverse8 views.
LENS_LIST, LENS_LIST_STEPS = ("pinhole", "radial-tangential", "fisheye"), 10
MV_WARMUP, MV_CALLS = 2, 10  # mipmap views: calls before timing, timed calls
GS_HW, GS_CALLS = 512, 10  # grid_scatter's output texture; timed calls of grid_scatter and filter2d
# The row-sharded step: 4 ranks, spawned once, run the textured scene on a (1, 4) mesh, a (2, 2) mesh of 2
# jittered cameras, and a (1, 2) mesh over ranks 0-1; 3 warm-up steps, 10 timed.
SHARDED_RANKS, SHARDED_MESHES = 4, (("(1, 4)", 4, 1), ("(2, 2)", 4, 2), ("(1, 2) of 4", 2, 1))
SHARDED_WARMUP, SHARDED_STEPS = 3, 10
SHARDED_PER_STEP = {"B1 rasterize": 1, "B2 gather_rows": 2, "B3 scatter_rows": 1, "B4 window_accum": 1,
                    "B5 rasterize_lines": 0, "E1 edge_grad": 1, "M1 mipmap_sample": 0, "R1 render": 2}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def published_peaks(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, f32 FLOP/s outside the tensor cores) from
    NVIDIA's data sheets for the card ``name``."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name:
        return 3.35e12, 67e12
    if "H200" in name:
        return 4.8e12, 67e12
    raise RuntimeError(f"no published peaks for {name!r}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls,
    from CUDA events around the whole run, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the device alone: ``reps``
    calls captured in one CUDA graph, ``replays`` replays timed with CUDA
    events. The host's time to prepare and launch each call, which
    ``cuda_ms`` counts when it exceeds the device's, is left out; the gaps
    between a call's own launches are not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on a side stream, as capture requires
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def device_profile(step, n_steps: int) -> dict | None:
    """Device records of ``n_steps`` calls of ``step`` under torch.profiler:
    device operations per step, the share of the device window in which some
    operation ran, the costliest device operations, and the PyTorch
    operators (with their input shapes) whose own device time is the
    largest (ms per step). None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (end - start)
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    operators = sorted(
        ((f"{e.key} {e.input_shapes}"[:160], e.self_device_time_total)
         for e in prof.key_averages(group_by_input_shape=True) if e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )[:12]
    return {
        "steps": n_steps, "device_ops_per_step": len(spans) / n_steps,
        "device_busy_ms_per_step": busy / n_steps / 1e3, "device_window_ms_per_step": window / n_steps / 1e3,
        "device_busy_share": busy / window if window > 0 else None,
        "top_device_ops_ms_per_step": {name: us / n_steps / 1e3 for name, us in top},
        "top_operators_device_ms_per_step": {name: us / n_steps / 1e3 for name, us in operators},
    }


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|; 0 where both are all zero."""
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def check_raster(name, d_ref, i_ref, d, i) -> dict:
    """The rasterizer parity rule: index flips only at depth ties (depths
    equal to 1e-4 relative), on fewer than 1e-3 of the pixels; depth to
    rtol 1e-4 / atol 1e-6."""
    mism = i_ref != i
    share = mism.float().mean().item()
    near_tie = (d_ref - d).abs() <= 1e-4 * d_ref.abs() + 1e-6
    if share >= 1e-3 or not bool(near_tie[mism].all()):
        raise AssertionError(f"{name}: {int(mism.sum())} index mismatches, not all at depth ties")
    torch.testing.assert_close(d, d_ref, rtol=1e-4, atol=1e-6)
    return {"index_mismatches": int(mism.sum()), "max_abs_depth_err": (d - d_ref).abs().max().item()}


# Models of the global atomics kernels B3 and B4 issue, from their tilings
# (csrc/scatter_rows.cu, csrc/window_accum.cu): counted from the index image
# or the taps, not read from the kernels, which count nothing. The CPU tests
# hold them to numpy emulations of the kernels' algorithms.
SCATTER_TILE = (8, 32)  # B3's pixel tile (rows, columns): kTileH x kTileW


def modeled_scatter_atomics(index_img: torch.Tensor, num_faces: int, k_dim: int) -> int:
    """Global atomics of B3's design for ``index_img``: one per (pixel tile,
    distinct clamped foreground face, k)."""
    n, h, w = index_img.shape
    if num_faces == 0:
        return 0
    tile_h, tile_w = SCATTER_TILE
    dev = index_img.device
    tiles_x = -(-w // tile_w)
    tile = (torch.arange(h, device=dev) // tile_h)[:, None] * tiles_x + (torch.arange(w, device=dev) // tile_w)
    n_tiles = -(-h // tile_h) * tiles_x
    key = (torch.arange(n, device=dev)[:, None, None] * n_tiles + tile) * num_faces
    key = key + index_img.long().clamp(max=num_faces - 1)
    return int(torch.unique(key[index_img >= 0]).numel()) * k_dim


RENDER_WARP = 32  # R1's backward: a warp per 32-pixel run of a tile row (kTileW)


def modeled_render_atomics(index_img: torch.Tensor, num_faces: int) -> dict:
    """Global atomics of R1's backward pixel pass (to face rows) for
    ``index_img``, nine per add, zeros not skipped: with the warp's
    combine, one add per run of equal clamped foreground faces in a warp's
    32 pixels (``combined``); without, one per foreground pixel
    (``per_pixel``). The fold to the vertices adds at most 9 per face."""
    n, h, w = index_img.shape
    face = torch.where(index_img >= 0, index_img.long().clamp(max=max(num_faces - 1, 0)), -1)
    starts = torch.ones_like(face, dtype=torch.bool)
    starts[..., 1:] = face[..., 1:] != face[..., :-1]
    starts[..., ::RENDER_WARP] = True
    fg = face >= 0
    return {"combined": int((starts & fg).sum()) * 9, "per_pixel": int(fg.sum()) * 9}


def b4_warp_patch(rows_hw: tuple[int, int]) -> tuple[int, int]:
    """The taps (rows, columns) a warp of B4 takes on a ``rows_hw`` tap grid:
    4 x 8, or 1 x 32 on a grid of fewer than 8 rows."""
    return (4, 8) if rows_hw[0] >= 8 else (1, 32)


def modeled_window_atomics(iy: torch.Tensor, ix: torch.Tensor, out_h: int, out_w: int, k_dim: int,
                           rows_hw: tuple[int, int]) -> int:
    """Global atomics of B4's design for these taps on their ``rows_hw``
    grid: one per (warp patch, distinct texel its live taps touch, k)."""
    n, p = iy.shape
    r_h, r_w = rows_hw
    patch_h, patch_w = b4_warp_patch(rows_hw)
    dev = iy.device
    patches_x = -(-r_w // patch_w)
    per_image = -(-r_h // patch_h) * patches_x
    patch = (torch.arange(r_h, device=dev) // patch_h)[:, None] * patches_x + torch.arange(r_w, device=dev) // patch_w
    patch = torch.arange(n, device=dev)[:, None] * per_image + patch.reshape(1, -1)
    live = (iy >= 0) & (iy < out_h) & (ix >= 0) & (ix < out_w)
    key = (patch.expand(n, p)[live] * out_h + iy[live].long()) * out_w + ix[live].long()
    return int(torch.unique(key).numel()) * k_dim


# Kernel B5's per-edge rejects (csrc/rasterize_lines.cu: load_tri,
# line_reach, box_sides, edge_sides), copied in torch to model how many
# (pixel, edge) side tests survive them; the kernel counts nothing. Each op
# rounds on its own in float32, as in the kernel. The CPU tests' emulation
# of the kernel runs this copy, and a property test holds it to the full
# side test.
def b5_edge_sides(p1x, p1y, p2x, p2y, visible, window, px, py, stage: int) -> torch.Tensor:
    """Bits 0-3: the diamond sides at pixel centres (px, py) on which the
    edge (p1, p2) of a triangle with pixel window ``window`` (x_lo, x_hi,
    y_lo, y_hi) is left to test by the box reject alone (``stage`` 1), by
    the box and line rejects (2), or that the kernel queues (3: the line
    reject, and the box reject only where the line reject does not apply;
    the queue's lane applies the box reject to the rest). None where the
    edge is invisible, all four where a0, b0 or c0 is not finite. float32
    tensors in, int32 out."""
    x_lo, x_hi, y_lo, y_hi = window
    a0, b0, c0 = p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y
    finite = torch.isfinite(a0) & torch.isfinite(b0) & torch.isfinite(c0)
    xl, xr, yt, yb = px - 0.5, px + 0.5, py - 0.5, py + 0.5
    right = ~(((p1x < px) & (p2x < px)) | ((p1x > xr) & (p2x > xr)))
    left = ~(((p1x < xl) & (p2x < xl)) | ((p1x > px) & (p2x > px)))
    top = ~(((p1y < yt) & (p2y < yt)) | ((p1y > py) & (p2y > py)))
    bottom = ~(((p1y < py) & (p2y < py)) | ((p1y > yb) & (p2y > yb)))
    box = ((right & top).int() | (right & bottom).int() << 1 | (left & bottom).int() << 2
           | (left & top).int() << 3)
    sides = box
    if stage >= 2:
        m, c = torch.maximum(a0.abs(), b0.abs()), c0.abs()
        guard = finite & (m <= 2.0**40) & (c <= 2.0**80) & (x_lo >= 1) & (y_lo >= 1) & (x_hi <= 2**22) & (y_hi <= 2**22)
        for v in (a0.abs(), b0.abs(), c):
            guard &= (v == 0) | (v >= 2.0**-100)
        x, y = x_hi.float() + 0.5, y_hi.float() + 0.5
        sxy, xy = x + y, x * y
        e2 = 2.0**-22 * xy + 2.0**-24 * sxy
        c2 = 0.5 * sxy + e2
        two_m = 2.0 * m
        r1 = (0.5 * m + two_m * (e2 + 2.0**-22 * sxy)) + 2.0**-22 * (m * sxy + c)
        r2 = (two_m * 2.0**-22) * (two_m * c2 + c)
        big_l = ((a0 * px + b0 * py) + c0).abs()
        reach = [torch.where(d == 0, -1.0, (r1 + (1.0 / d) * r2) * (1 + 2.0**-18))
                 for d in (0.5 * (a0 + b0).abs(), 0.5 * (a0 - b0).abs())]
        if stage >= 3:  # the box reject left to the queue's lane where the line reject applies
            sides = torch.where(guard, 0xF, box).int()
        for r, pair in zip(reach, (0x5, 0xA)):
            sides &= torch.where(guard & (big_l > r), 0xF & ~pair, 0xF).int()
    return torch.where(visible, torch.where(finite, sides, 0xF), 0)


B5_EDGES = ((9, 11), (11, 13), (9, 13))  # row offsets of the corners of edges (p0, p1), (p1, p2), (p0, p2)


def modeled_edge_tests(rows: torch.Tensor, meta: torch.Tensor, ends: torch.Tensor, chunk: int = 1 << 22) -> dict:
    """Per window pixel of kernel B5's launch: the visible edges, the
    (pixel, edge) pairs and side tests left after the box reject and after
    the box and line rejects, and the pairs and sides the kernel queues; a
    model from the packed rows, in chunks of ``chunk`` pixels."""
    total = int(ends[-1]) if ends.numel() else 0
    flat_rows, flat_meta = rows.reshape(-1, rows.shape[-1]), meta.reshape(-1, meta.shape[-1]).long()
    sums = dict.fromkeys(("visible", "edges_box", "edges_line", "edges_queued", "sides_box", "sides_line",
                          "sides_queued"), 0)
    for start in range(0, total, chunk):
        t = torch.arange(start, min(total, start + chunk), device=ends.device)
        i = torch.searchsorted(ends, t, right=True)
        off = t - torch.where(i > 0, ends[(i - 1).clamp(min=0)], 0)
        r, m = flat_rows[i], flat_meta[i]
        cols = m[:, 2] - m[:, 1] + 1
        px = (m[:, 1] + off % cols).float()
        py = (m[:, 3] + off // cols).float()
        window = (m[:, 1], m[:, 2], m[:, 3], m[:, 4])
        for k, (a, b) in enumerate(B5_EDGES):
            vis = (m[:, 0] >> (3 + k)) & 1 == 1
            sums["visible"] += int(vis.sum())
            for stage, name in ((1, "box"), (2, "line"), (3, "queued")):
                sides = b5_edge_sides(r[:, a], r[:, a + 1], r[:, b], r[:, b + 1], vis, window, px, py, stage)
                sums[f"edges_{name}"] += int((sides != 0).sum())
                sums[f"sides_{name}"] += int(sum(((sides >> bit) & 1).sum() for bit in range(4)))
    return {"window_pixels": total, **{k: v / max(total, 1) for k, v in sums.items()}}


def near_miss_scene(h: int = 64, w: int = 128, seed: int = 0) -> dict:
    """Triangles whose first edge passes a pixel's unit diamond at its reach:
    through one of its corners, tangent to it a hair outside, or along one
    of its sides, nearly parallel to it, each endpoint then moved up to two
    ulps either way; the third corner lies 3-6 pixels off the edge. One
    triangle per pixel centre on a 4-pixel grid, float32 ``v`` [1, 3F, 3]
    and ``vi`` [F, 3] int32."""
    rng = np.random.RandomState(seed)
    corners = np.array([[0.5, 0.0], [0.0, 0.5], [-0.5, 0.0], [0.0, -0.5]])
    side_mid = np.array([[0.25, -0.25], [0.25, 0.25], [-0.25, 0.25], [-0.25, -0.25]])
    side_dir = np.array([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    verts = []
    for k, (py, px) in enumerate((py, px) for py in range(4, h - 4, 4) for px in range(4, w - 4, 4)):
        kind, which = k % 3, (k // 3) % 4
        if kind == 1:  # along a side, its direction turned by a hair
            q = np.array([px, py]) + side_mid[which] + rng.choice([0.0, 1e-6, -1e-6]) * side_dir[which][::-1]
            ang = np.arctan2(side_dir[which][1], side_dir[which][0]) + rng.choice([0.0, 1e-7, -1e-7, 1e-5])
        else:  # through a corner (kind 0) or a hair outside it (kind 2)
            q = np.array([px, py]) + corners[which] * (1.0 if kind == 0 else 1.0 + rng.uniform(1e-7, 1e-5))
            ang = rng.uniform(0.0, np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        p1, p2 = q - rng.uniform(1.0, 8.0) * d, q + rng.uniform(1.0, 8.0) * d
        p3 = (p1 + p2) / 2 + rng.choice([-1.0, 1.0]) * rng.uniform(3.0, 6.0) * np.array([-d[1], d[0]])
        tri = np.stack([p1, p2, p3]).astype(np.float32)
        steps = rng.randint(-2, 3, (2, 2))
        for j in range(2):
            for c in range(2):
                for _ in range(abs(steps[j, c])):
                    tri[j, c] = np.nextafter(tri[j, c], np.float32(np.sign(steps[j, c]) * np.inf))
        verts.append(np.concatenate([tri, rng.uniform(3.0, 9.0, (3, 1)).astype(np.float32)], axis=1))
    v = np.concatenate(verts)[None].astype(np.float32)
    return {"v": v, "vi": np.arange(v.shape[1], dtype=np.int32).reshape(-1, 3)}



def sharded_scene(batch: int) -> dict[str, np.ndarray]:
    """The textured scene for ``batch`` cameras: batch 2 jitters each copy
    of the vertices by up to 3 pixels (as tests/test_spmd.py does) and
    flips the second texture; a seeded weight image for the loss."""
    from drtk_tpu_torch.scenes import make_scene_arrays

    s = make_scene_arrays(H, W, GN)
    rng = np.random.RandomState(3)
    if batch > 1:
        s["v"] = (s["v"] + rng.uniform(-3, 3, size=(batch, 1, 3))).astype(np.float32)
        s["vt"] = np.repeat(s["vt"], batch, 0)
        s["tex"] = np.concatenate([s["tex"], s["tex"][:, :, ::-1]])[:batch].copy()
    s["weight"] = rng.randn(batch, 3, H, W).astype(np.float32)
    return s


def sharded_rank(rank: int, world: int, store: str, backend: str, outdir: str) -> None:
    """One rank of the row-sharded step (spawned): for each of
    SHARDED_MESHES it lies in, the step's kernel launches, its gathered
    frame against render_textured on one process (bit for bit), its
    gradients against fit_step's (1e-4 of the largest magnitude), then
    SHARDED_WARMUP + SHARDED_STEPS Adam steps timed, 3 more profiled, and
    the step's collectives timed alone; a JSON record per mesh into
    ``outdir``. Under NCCL each rank takes its own card; under Gloo
    every rank shares card 0."""
    import torch.distributed as dist

    import drtk_tpu_torch as tt
    from drtk_tpu_torch.ops import edge_grad as edge_grad_mod
    from drtk_tpu_torch.ops.math import next_rank_rows
    from drtk_tpu_torch.parallel import multihost, sharding, spmd
    from drtk_tpu_torch.pipeline import fit_step, render_textured

    card = rank if backend == "nccl" else 0
    torch.cuda.set_device(card)
    dev = torch.device("cuda", card)
    multihost.initialize(f"file://{store}", world, rank, backend=backend)
    try:
        for label, n_dev, batch in SHARDED_MESHES:
            mesh = sharding.make_mesh(n_dev, batch=batch, device_type="cuda")
            if mesh.get_coordinate() is None:
                continue
            d, j = mesh.get_coordinate()
            data, pix = mesh.shape
            nb, hb = batch // data, H // pix
            s = {k: torch.from_numpy(a).to(dev) for k, a in sharded_scene(batch).items()}
            cams = slice(d * nb, (d + 1) * nb)
            w_block = s["weight"][cams, :, j * hb:(j + 1) * hb]
            leaves = [s[k][cams].clone().requires_grad_() for k in ("v", "vt", "tex")]
            fwd = spmd.make_row_sharded_forward(mesh, s["vi"], H, W)
            torch.cuda.synchronize()
            tt.reset_kernel_launch_counts()
            e1_args, e1_launch = [], edge_grad_mod._e1_cuda

            def e1_spy(*args, **kwargs):
                e1_args.append(args)
                return e1_launch(*args, **kwargs)

            edge_grad_mod._e1_cuda = e1_spy
            try:
                block = fwd(*leaves)
                grads = torch.autograd.grad((block * w_block).sum(), leaves)
            finally:
                edge_grad_mod._e1_cuda = e1_launch
            torch.cuda.synchronize()
            check_launches = tt.kernel_launch_counts()
            if check_launches != SHARDED_PER_STEP:
                raise AssertionError(f"rank {rank} {label}: launches {check_launches}, expected {SHARDED_PER_STEP}")
            # E1 on the rank's own launch (its block and the halo row)
            # against the plain version.
            e1_got = edge_grad_mod._e1_cuda(*e1_args[0])
            e1_want = edge_grad_mod._verts_plain(*e1_args[0])
            e1_check = {"rel_err": rel_err(e1_got, e1_want), "nonzero_equal": bool(torch.equal(e1_got != 0,
                                                                                                e1_want != 0)),
                        "nonzero": int((e1_want != 0).sum()), "rows": int(e1_args[0][2].shape[1])}
            if not (e1_check["nonzero_equal"] and e1_check["rel_err"] <= 1e-5):
                raise AssertionError(f"rank {rank} {label}: E1 against its plain version {e1_check}")
            del e1_args, e1_got, e1_want
            frame = spmd.gather_frame(block, mesh)
            with torch.no_grad():
                img_ref, _ = render_textured(s["v"], s["vi"], s["vt"], s["tex"], H, W)
            if not torch.equal(frame, img_ref):
                raise AssertionError(f"rank {rank} {label}: the gathered frame differs from one process's")
            _, grads_ref = fit_step(s["v"][cams], s["vi"], s["vt"][cams], s["tex"][cams], H, W,
                                    weight=s["weight"][cams])
            grad_err = {k: rel_err(g, grads_ref[k]) for k, g in zip(("v", "vt", "tex"), grads)}
            if not all(e <= 1e-4 for e in grad_err.values()):
                raise AssertionError(f"rank {rank} {label}: gradients differ from one process's by {grad_err}")
            del frame, img_ref, grads_ref, grads, block

            opt = torch.optim.Adam(leaves, lr=1e-3)

            def step():
                opt.zero_grad(set_to_none=True)
                (fwd(*leaves) * w_block).sum().backward()
                opt.step()

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            tt.reset_kernel_launch_counts()
            step_ms = []
            for _ in range(SHARDED_WARMUP + SHARDED_STEPS):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = tt.kernel_launch_counts()
            n_steps = SHARDED_WARMUP + SHARDED_STEPS
            if launches != {k: c * n_steps for k, c in SHARDED_PER_STEP.items()}:
                raise AssertionError(f"rank {rank} {label}: launches {launches} over {n_steps} steps")
            peak = torch.cuda.max_memory_allocated(dev)
            profile = device_profile(step, 3)
            # The step's collectives alone, as the step calls them: the three
            # gradients' all-reduces and one halo exchange.
            group = mesh.get_group("pix")
            grads_like = [x.detach().clone() for x in leaves]
            firsts = [torch.zeros((nb, 3, 1, W), device=dev) for _ in range(3)] + [
                torch.zeros((nb, 1, W), dtype=torch.int32, device=dev)]

            def comm_ms(fn, reps=10):
                fn()
                torch.cuda.synchronize()
                dist.barrier(group=group)
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / reps

            all_reduce_ms = comm_ms(lambda: [dist.all_reduce(g, group=group) for g in grads_like])
            halo_ms = comm_ms(lambda: next_rank_rows(firsts, (0, 0, 0, -1), group))
            row_bytes = nb * W * 4 * (3 + 3 + 3 + 1)  # img, cotangent, bary rows; the index row
            rec = {
                "mesh": label, "rank": rank, "coord": [d, j], "batch": batch, "cameras": nb, "rows": hb,
                "device": str(dev), "launches_check": check_launches, "launches": launches, "e1_vs_plain": e1_check,
                "grad_rel_err_vs_one_process": grad_err, "frame_bit_equal": True,
                "halo_bytes_sent_per_step": row_bytes if j > 0 else 0,
                "halo_bytes_received_per_step": row_bytes if j < pix - 1 else 0,
                "step_ms_median": statistics.median(step_ms[SHARDED_WARMUP:]),
                "step_ms_min": min(step_ms[SHARDED_WARMUP:]), "step_ms_max": max(step_ms[SHARDED_WARMUP:]),
                "all_reduce_ms_per_step": all_reduce_ms, "halo_ms_per_step": halo_ms,
                "gradient_bytes_all_reduced": sum(g.numel() * g.element_size() for g in grads_like),
                "peak_mem_bytes": peak,
                "device_busy_ms_per_step": profile["device_busy_ms_per_step"] if profile else None,
                "device_ops_per_step": profile["device_ops_per_step"] if profile else None,
                "device_busy_share": profile["device_busy_share"] if profile else None,
            }
            with open(os.path.join(outdir, f"{label}-{rank}.json"), "w") as f:
                json.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()



def render_bytes(v, vi, index_img, backward: bool) -> int:
    """The bytes R1's function needs, each read or written once: the index,
    v and vi (a shared vi once), and forward depth and bary written, or
    backward the two cotangents read and the vertex gradient written."""
    elt = v.element_size()
    px = index_img.numel()
    faces = vi.shape[1] * 3 * 4 * (1 if vi.stride(0) == 0 else vi.shape[0])
    per_px = 4 + 4 * elt
    return px * per_px + v.numel() * elt * (2 if backward else 1) + faces


def r1_record(label, v, vi, index_img, y_offset, bw) -> dict:
    """Kernel R1 against the plain version on one input: the forward bit
    for bit, the backward to 1e-5 (f64 1e-12) of the plain gradient's
    largest magnitude; its ms and device ms each way, the bound from
    ``render_bytes``, the plain version's ms and the path it replaced (B2,
    eager ops, B3 and ``index_add_``: impl "auto" of the plain math), and
    the modeled atomics."""
    from drtk_tpu_torch.ops import render as render_mod

    dev = v.device
    gen = torch.Generator(device=dev).manual_seed(0)
    n, h, w = index_img.shape
    grad_depth = torch.randn((n, h, w), generator=gen, device=dev, dtype=v.dtype)
    grad_bary = torch.randn((n, 3, h, w), generator=gen, device=dev, dtype=v.dtype)
    cot = (grad_depth, grad_bary)

    def launch(cotangents=None):
        return render_mod._r1_cuda(v, vi, index_img, y_offset, cotangents)

    depth, bary = launch()
    grad = launch(cot)
    want_depth, want_bary = render_mod._render_fwd_math(v, vi, index_img, "plain", y_offset)
    want = render_mod._render_bwd_math(v, vi, index_img, grad_depth, grad_bary, "plain", y_offset)
    torch.cuda.synchronize()
    if not (torch.equal(depth, want_depth) and torch.equal(bary, want_bary)):
        raise AssertionError(f"R1 {label}: the forward differs from the plain version")
    err = rel_err(grad, want)
    if err > (1e-12 if v.dtype == torch.float64 else 1e-5):
        raise AssertionError(f"R1 {label}: the backward is {err} of its largest magnitude off the plain version")
    fwd_bytes, bwd_bytes = render_bytes(v, vi, index_img, False), render_bytes(v, vi, index_img, True)
    return {
        "input": label, "batch": n, "H": h, "W": w, "y_offset": y_offset, "faces": vi.shape[1],
        "dtype": str(v.dtype), "coverage": (index_img >= 0).float().mean().item(), "forward_bit_exact": True,
        "backward_rel_err": err,
        "fwd_ms": cuda_ms(launch, 20), "fwd_device_ms": graph_ms(launch),
        "bwd_ms": cuda_ms(lambda: launch(cot), 20), "bwd_device_ms": graph_ms(lambda: launch(cot)),
        "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
        "fwd_bound_ms": fwd_bytes / bw * 1e3, "bwd_bound_ms": bwd_bytes / bw * 1e3,
        "plain_fwd_ms": cuda_ms(lambda: render_mod._render_fwd_math(v, vi, index_img, "plain", y_offset), 5),
        "plain_bwd_ms": cuda_ms(
            lambda: render_mod._render_bwd_math(v, vi, index_img, grad_depth, grad_bary, "plain", y_offset), 5),
        "replaced_fwd_ms": cuda_ms(lambda: render_mod._render_fwd_math(v, vi, index_img, "auto", y_offset), 5),
        "replaced_bwd_ms": cuda_ms(
            lambda: render_mod._render_bwd_math(v, vi, index_img, grad_depth, grad_bary, "auto", y_offset), 5),
        "modeled_atomics": modeled_render_atomics(index_img, vi.shape[1]),
    }


def render_frames(dev) -> dict:
    """R1's inputs at the benchmark's sizes: inverse8's frame (8 views of
    1024^2 of the 161^2 grid through transform, one vi for all) and a card's
    block of multiview4k.rows4 (rows [1024, 2048) of 8 cameras of 4096^2,
    the 226^2 grid moved by up to 3 px each, y_offset 1024). Each: (v, vi,
    index, y_offset)."""
    import drtk_tpu_torch as tt
    from drtk_tpu_torch.ops.rasterize import broadcast_vi
    from drtk_tpu_torch.scenes import avatar4k_scene_arrays, inverse8_scene_arrays

    s = {k: torch.from_numpy(a).to(dev) for k, a in inverse8_scene_arrays(1024, 161, 8, tex_size=8).items()}
    cams = {k: s[k] for k in CAMS}
    with torch.no_grad():
        v8 = tt.transform(s["v_world"].expand(8, -1, -1), **cams).contiguous()
    vi8 = broadcast_vi(s["vi"], 8)
    frames = {"inverse8 frame": (v8, vi8, tt.rasterize(v8, vi8, 1024, 1024), 0)}
    a = avatar4k_scene_arrays(AV_HW, AV_GN, 16)
    shift = np.random.RandomState(4).uniform(-3, 3, (8, 1, 2))
    vr = torch.from_numpy((a["v"] + np.concatenate([shift, np.zeros((8, 1, 1))], -1)).astype(np.float32)).to(dev)
    vir = broadcast_vi(torch.from_numpy(a["vi"]).to(dev), 8)
    frames["rows4 block"] = (vr, vir, tt.rasterize(vr, vir, 1024, AV_HW, y_offset=1024, full_height=AV_HW), 1024)
    return frames


def render_phase(bw) -> dict:
    """R1 against the plain version on ``render_frames``; a record each."""
    t_phase = time.perf_counter()
    recs = {}
    for label, (v, vi, idx, y0) in render_frames(torch.device("cuda")).items():
        recs[label] = r1_record(label, v, vi, idx, y0, bw)
        emit({"phase": "R1 vs plain", **recs[label]})
    emit({"phase": "R1 checks", "phase_seconds": time.perf_counter() - t_phase})
    return recs


def row_sharded_phase() -> dict:
    """The row-sharded step (drtk_tpu_torch.parallel.spmd) on the textured
    scene at 1024^2: SHARDED_RANKS ranks spawned once (``sharded_rank``) run
    SHARDED_MESHES, an Adam step on v, vt and tex. NCCL with a card per rank
    where there are that many cards; else Gloo, every rank on this card
    (their step times share its time: not a scaling figure). Emits a record
    per mesh; returns rank 0's record on the first mesh."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    backend = "nccl" if torch.cuda.device_count() >= SHARDED_RANKS else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(sharded_rank, args=(SHARDED_RANKS, os.path.join(tmp, "store"), backend, tmp),
                 nprocs=SHARDED_RANKS)
        sharded = {}
        for label, n_dev, _ in SHARDED_MESHES:
            recs = []
            for rank in range(n_dev):
                with open(os.path.join(tmp, f"{label}-{rank}.json")) as f:
                    recs.append(json.load(f))
            sharded[label] = recs
    for label, recs in sharded.items():
        emit({
            "phase": "row-sharded step", "config": "textured", "mesh": label, "H": H, "W": W, "backend": backend,
            "ranks": len(recs), "ranks_per_card": len(recs) if backend == "gloo" else 1,
            "warmup_steps": SHARDED_WARMUP, "steps_timed": SHARDED_STEPS, "per_rank": recs,
            "step_ms_median_max_over_ranks": max(r["step_ms_median"] for r in recs),
            "grad_rel_err_max": max(max(r["grad_rel_err_vs_one_process"].values()) for r in recs),
            "e1_rel_err_vs_plain_max": max(r["e1_vs_plain"]["rel_err"] for r in recs),
            "halo_bytes_per_step": sum(r["halo_bytes_sent_per_step"] for r in recs),
            **{f"{k}_max_over_ranks": max((r[k] for r in recs if r[k] is not None), default=None)
               for k in ("all_reduce_ms_per_step", "halo_ms_per_step", "device_busy_ms_per_step", "peak_mem_bytes")},
        })
    emit({"phase": "row-sharded checks", "backend": backend, "frames_bit_equal": True,
          "phase_seconds": time.perf_counter() - t_phase})
    return sharded[SHARDED_MESHES[0][0]][0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 2
    try:
        import drtk_tpu_torch as tt
        from drtk_tpu_torch import _build
        from drtk_tpu_torch.ops import rasterize as rast
        from drtk_tpu_torch.ops import grid_sample as gs
        from drtk_tpu_torch.ops import edge_grad as edge_grad_mod
        from drtk_tpu_torch.ops import mipmap_grid_sample as mipmap_mod
        from drtk_tpu_torch.ops import rasterize_cuda, segment_rows, window_accum
        from drtk_tpu_torch.ops import filter2d_ref
        from drtk_tpu_torch.ops.edge_grad import _stencil_table
        from drtk_tpu_torch.ops.render import _face_table
        from drtk_tpu_torch.interop import scene_from_numpy
        from drtk_tpu_torch.parallel import banded
        from drtk_tpu_torch.pipeline import (
            AVATAR4K_STAGES, BACKWARD_STAGES, FIT_STAGES, INVERSE8_STAGES, STAGES, avatar4k_background, avatar4k_band,
            avatar4k_loss, avatar4k_step, fit_step, inverse8_step, render_mipmap_multiview, render_multiview,
            render_textured, stage_ms,
        )
        from drtk_tpu_torch.scenes import (
            avatar4k_scene_arrays, box_pyramid, entry_scene, inverse8_lens_arrays, inverse8_scene_arrays, make_scene,
            with_edge_flags,
        )
        from drtk_tpu_torch.utils.geometry import face_dpdt
    except ImportError as err:
        print(f"chip_smoke: drtk_tpu_torch is not importable here ({err})", file=sys.stderr)
        return 3

    # 1. Device
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bw, f32_flops = published_peaks(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "mem_bytes_per_s": bw,
          "f32_flops_per_s": f32_flops})

    # 2. Build
    t0 = time.perf_counter()
    _build.build_all()
    ptxas = {k: [ln.strip() for ln in log.splitlines() if "Used" in ln] for k, log in _build.build_logs.items()}
    emit({"phase": "build", "dir": str(_build.BUILD_DIR), "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    if sys.argv[1:] == ["--sharded-only"]:
        # The row-sharded step alone, for a machine with a card per rank
        # (NCCL): the one phase that spans cards.
        row_sharded_phase()
        return finish(smi)
    if sys.argv[1:] == ["--render-only"]:
        render_phase(bw)  # kernel R1 alone, at the benchmark's sizes
        return finish(smi)

    v, vi, vt, tex = make_scene(H, W, GN, device=dev)
    n_faces = vi.shape[0]
    vib = rast.broadcast_vi(vi, v.shape[0])
    index_img = tt.rasterize(v, vi, H, W)

    # 3. B2 vs plain on the textured scene's index image (and, after phase
    # 13, on the inverse8 step's)
    def b2_vs_plain(image, tables, idx) -> dict:
        n = idx.shape[0]
        recs = {}
        for k_dim, table in tables.items():
            got = segment_rows.gather_rows_by_index(table, idx)
            want = segment_rows._gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"B2 {image} K={k_dim}: kernel differs from the plain gather")
            f_cnt = table.shape[1]
            padded = torch.cat([table.new_zeros((1, k_dim)), table.reshape(-1, k_dim)])  # row 0 = background
            offs = torch.arange(n, device=dev)[:, None, None] * f_cnt + 1
            lib_idx = torch.where(idx >= 0, idx.long() + offs, 0)
            if not torch.equal(torch.nn.functional.embedding(lib_idx, padded), got):
                raise AssertionError(f"B2 {image} K={k_dim}: the library yardstick computes another function")
            nbytes = table.numel() * 4 + idx.numel() * 4 + got.numel() * 4
            recs[k_dim] = {
                "ms": cuda_ms(lambda: segment_rows._gather_rows_cuda(table, idx), 50),
                "device_ms": graph_ms(lambda: segment_rows._gather_rows_cuda(table, idx)),
                "plain_ms": cuda_ms(lambda: segment_rows._gather_rows_plain(table, idx), 20),
                "library_ms": cuda_ms(lambda: torch.nn.functional.embedding(lib_idx, padded), 50),
                "library_device_ms": graph_ms(lambda: torch.nn.functional.embedding(lib_idx, padded)),
                "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": 0.0,
            }
            emit({"phase": "B2 vs plain", "image": image, "batch": n, "faces": f_cnt, "K": k_dim,
                  "bit_exact": True, **recs[k_dim]})
        return recs

    rng = np.random.RandomState(0)
    tables = {9: _face_table(v, vib), 6: _face_table(vt, vib)}  # render's vertex rows, interpolate's uv rows
    b2 = b2_vs_plain("textured", {
        # K = 16, the stencil rows' width: a check of B2 alone (no step gathers them since E1)
        **tables, 16: torch.from_numpy(rng.randn(1, n_faces, 16).astype(np.float32)).to(dev),
    }, index_img)

    # 4. B1 vs plain on the entry scene and the textured scene (and, in
    # phase 13, on the inverse8 step's views)
    def b1_vs_plain(scene, sv, svi, hh, ww, y0=0, frame_h=None) -> dict:
        """B1 on rows [y0, y0 + hh) of a frame of ``frame_h`` rows (default hh)."""
        frame_h = hh if frame_h is None else frame_h
        svib = rast.broadcast_vi(svi, sv.shape[0])
        setup = rast.triangle_setup(sv, svib)
        valid = rast._canvas_cull(setup, frame_h, ww)
        coef, meta = rasterize_cuda.pack_setup(setup, valid, hh, ww, y0)
        d, i, bins = rasterize_cuda._resolve_binned(coef, meta, hh, ww, y0)
        d_ref, i_ref = rast._rasterize_plain(setup, valid, hh, ww, y_offset=y0)
        torch.cuda.synchronize()
        rec = check_raster(f"B1 {scene}", d_ref, i_ref, d, i)
        if not (torch.equal(d, d_ref) and torch.equal(i, i_ref)):
            raise AssertionError(f"B1 {scene}: kernel not bit-identical to the plain resolve")
        m = meta.long()
        tests = ((m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)).sum().item()
        nbytes = coef.numel() * 4 + meta.numel() * 4 + d.numel() * 4 + i.numel() * 4
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = tests * FLOPS_PER_TEST / f32_flops * 1e3
        ms_runs = [cuda_ms(lambda: rasterize_cuda.resolve_packed(coef, meta, hh, ww, y0), 20) for _ in range(3)]
        rec.update({
            "H": hh, "W": ww, "y_offset": y0, "frame_H": frame_h, "batch": int(sv.shape[0]),
            "faces": int(svib.shape[1]), "bit_exact": True,
            "pairs": int(bins.starts[-1]), "pair_capacity": bins.pairs.numel(),
            "big_list": int(bins.big_count.sum()),
            "bins_bytes": 4 * sum(rasterize_cuda._bin_sizes(*coef.shape[:2], hh, ww)),
            "ms": statistics.median(ms_runs), "ms_runs": ms_runs,
            "device_ms": graph_ms(lambda: rasterize_cuda.resolve_packed(coef, meta, hh, ww, y0)),
            "plain_ms": cuda_ms(lambda: rast._rasterize_plain(setup, valid, hh, ww, y_offset=y0), 2, warmup=1),
            "rasterize_call_ms": cuda_ms(
                lambda: tt.rasterize_with_depth(sv, svi, hh, ww, y_offset=y0, full_height=frame_h), 20),
            "pixel_centres_tested": tests, "bytes": nbytes,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations", "library_ms": None,
        })
        emit({"phase": "B1 vs plain", "scene": scene, **rec})
        return rec

    entry = entry_scene(h=ENTRY_HW, w=ENTRY_HW, device=dev)
    b1 = {"entry": b1_vs_plain("entry", entry[0], entry[1], ENTRY_HW, ENTRY_HW),
          "textured": b1_vs_plain("textured", v, vi, H, W)}

    # 5. The main path: render_textured at full size, through the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_kernel_launch_counts()
    step_marks = []
    host_s = []
    for _ in range(WARMUP + STEPS):
        marks = []
        t0 = time.perf_counter()
        img, idx = render_textured(v, vi, vt, tex, H, W, stage_times=marks)
        host_s.append(time.perf_counter() - t0)
        step_marks.append(marks)
    torch.cuda.synchronize()
    launches = tt.kernel_launch_counts()
    n_steps = WARMUP + STEPS
    if launches != {"B1 rasterize": n_steps, "B2 gather_rows": n_steps, "B3 scatter_rows": 0,
                    "B4 window_accum": 0, "B5 rasterize_lines": 0, "E1 edge_grad": 0, "M1 mipmap_sample": 0,
                    "R1 render": n_steps}:
        raise AssertionError(f"main path launches {launches} over {n_steps} steps, expected 1 B1, 1 B2 and 1 R1 "
                             "per step")
    peak = torch.cuda.max_memory_allocated()
    per_stage = [stage_ms(marks) for marks in step_marks[WARMUP:]]
    step_ms = [sum(s.values()) for s in per_stage]
    med_ms = statistics.median(step_ms)
    if not bool(torch.isfinite(img).all()) or img.shape != (1, 3, H, W):
        raise AssertionError(f"main path output: shape {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    coverage = (idx >= 0).float().mean().item()
    profile = device_profile(lambda: render_textured(v, vi, vt, tex, H, W), PROFILED_STEPS)

    # ...held against the same pipeline through the plain versions, each
    # side with its own index image.
    img_p, idx_p = render_textured(v, vi, vt, tex, H, W, impl="plain")
    agree = idx == idx_p
    if agree.float().mean().item() <= 1 - 1e-3:
        raise AssertionError("main path: kernel and plain index images differ on >= 1e-3 of the pixels")
    for k_dim in (9, 6):
        g = segment_rows._gather_rows_cuda(tables[k_dim], idx)
        g_p = segment_rows._gather_rows_plain(tables[k_dim], idx_p)
        if not torch.equal(g[agree], g_p[agree]):
            raise AssertionError(f"main path: gathered K={k_dim} rows differ where the index images agree")
    agree_c = agree[:, None].expand_as(img)
    img_err = (img[agree_c] - img_p[agree_c]).abs().max().item()
    if img_err > 1e-5:
        raise AssertionError(f"main path: image differs from the plain pipeline by {img_err}")
    # ...and the f64 reference oracle of render on the kernel's index image.
    _, bary = tt.render(v, vi, idx)
    _, bary_ref = tt.render_ref(v, vi, idx)
    bary_err = (bary.double() - bary_ref.double()).abs().max().item()
    if bary_err > 1e-4:
        raise AssertionError(f"main path: bary differs from render_ref by {bary_err}")

    emit({
        "phase": "main path", "config": "textured", "H": H, "W": W, "faces": n_faces,
        "steps_timed": STEPS, "step_ms_median": med_ms, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mpix_per_s": H * W / (med_ms * 1e-3) / 1e6,
        "host_ms_per_call_median": statistics.median(host_s[WARMUP:]) * 1e3,
        "stage_ms_median": {s: statistics.median(p[s] for p in per_stage) for s in STAGES},
        "peak_mem_bytes": peak, "coverage": coverage, "launches": launches,
        "index_agree_share": agree.float().mean().item(), "max_abs_img_err_vs_plain": img_err,
        "max_abs_bary_err_vs_render_ref": bary_err, "profile": profile,
    })
    peaks = {"forward": peak}

    # 5b. R1 vs plain at the benchmark's sizes: inverse8's frame and a rows4
    # block.
    r1 = render_phase(bw)

    # 6. B3 vs plain: rows from a seeded generator on the textured scene's
    # index image (and, after phase 13, on the inverse8 step's), with the
    # global atomics of the kernel's design, modeled, against a per-pixel
    # scatter's.
    gen = torch.Generator(device=dev).manual_seed(0)
    b3_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")

    def b3_record(image, rows, idx, f_cnt) -> dict:
        """B3 against its plain version and ``index_add_`` on these rows."""
        n, k_dim = idx.shape[0], rows.shape[-1]
        fg = idx >= 0
        n_fg = int(fg.sum())
        lib_idx = (idx.long().clamp(max=f_cnt - 1) + torch.arange(n, device=dev)[:, None, None] * f_cnt)[fg]
        got = segment_rows.scatter_rows_to_faces(rows, idx, f_cnt)
        want = segment_rows._scatter_rows_plain(rows, idx, f_cnt)
        magnitude = segment_rows._scatter_rows_plain(rows.abs(), idx, f_cnt)
        lib_rows = rows[fg]

        def library():
            return torch.zeros((n * f_cnt, k_dim), device=dev).index_add_(0, lib_idx, lib_rows)

        torch.cuda.synchronize()
        err = (got - want).abs()
        # atomics reorder the sums: rtol 1e-5, atol 1e-6 of the summed magnitudes
        if not bool((err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(
                f"B3 {image} K={k_dim}: kernel differs from the plain scatter by {err.max().item()}")
        lib_err = (library().reshape(n, f_cnt, k_dim) - want).abs()
        if not bool((lib_err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B3 {image} K={k_dim}: the library yardstick computes another function")
        nbytes = n_fg * k_dim * 4 + idx.numel() * 4 + n * f_cnt * k_dim * 4
        atomics = modeled_scatter_atomics(idx, f_cnt, k_dim)
        rec = {
            "ms": cuda_ms(lambda: segment_rows._scatter_rows_cuda(rows, idx, f_cnt), 50),
            "device_ms": graph_ms(lambda: segment_rows._scatter_rows_cuda(rows, idx, f_cnt)),
            "plain_ms": cuda_ms(lambda: segment_rows._scatter_rows_plain(rows, idx, f_cnt), 20),
            "library_ms": cuda_ms(library, 50), "library_device_ms": graph_ms(library),
            "library": "index_add_ of the foreground rows (the plain "
            "version's core, without its masking)", "foreground_pixels": n_fg,
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": err.max().item(),
            "modeled_global_atomics": atomics, "modeled_per_pixel_atomics": n_fg * k_dim,
            "modeled_atomics_fall": n_fg * k_dim / max(atomics, 1),
        }
        emit({"phase": "B3 vs plain", "image": image, "batch": n, "faces": f_cnt, "K": k_dim,
              "rows_shape": list(rows.shape), **rec})
        return rec

    def b3_vs_plain(image, idx, f_cnt) -> dict:
        return {k_dim: b3_record(image, torch.randn((*idx.shape, k_dim), generator=gen, device=dev), idx, f_cnt)
                for k_dim in (9, 6)}

    b3 = b3_vs_plain("textured", index_img, n_faces)

    # 7. B4 vs plain on the taps of a step's own grid_sample: the quad-row
    # index of every pixel's bilinear border sample of the texture, the taps
    # in their H x W shape, as grid_sample passes them (textured here, the
    # inverse8 step's after phase 13), with the global atomics of the
    # kernel's design, modeled, against a per-tap scatter's.

    def b4_record(image, args) -> dict:
        """B4 against its plain version and ``index_add_`` on its arguments
        (rows [N, K, P], iy, ix, table height and width, rows_hw)."""
        rows_kp, iy, ix, t_h, t_w, rows_hw = args
        n, k4, _ = rows_kp.shape
        live = (iy >= 0) & (iy < t_h) & (ix >= 0) & (ix < t_w)
        n_live = int(live.sum())
        got = window_accum._window_accumulate_cuda(*args)
        want = window_accum._window_accumulate_plain(*args[:5])
        magnitude = window_accum._window_accumulate_plain(rows_kp.abs(), *args[1:5])
        lib_flat = ((iy.long() * t_w + ix) + torch.arange(n, device=dev)[:, None] * (t_h * t_w))[live]
        lib_rows = rows_kp.movedim(1, 0)[:, live].contiguous()

        def library_b4():
            return torch.zeros((k4, n * t_h * t_w), device=dev).index_add_(1, lib_flat, lib_rows)

        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B4 {image}: kernel differs from the plain scatter by {err.max().item()}")
        lib = library_b4().reshape(k4, n, t_h, t_w).movedim(0, 1)
        if not bool(((lib - want).abs() <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B4 {image}: the library yardstick computes another function")
        nbytes = n_live * k4 * 4 + iy.numel() * 4 + ix.numel() * 4 + n * k4 * t_h * t_w * 4
        atomics = modeled_window_atomics(iy, ix, t_h, t_w, k4, rows_hw)
        rec = {
            "K": k4, "batch": n, "taps": iy.numel(), "live_taps": n_live, "rows_hw": list(rows_hw),
            "table": [t_h, t_w],
            "ms": cuda_ms(lambda: window_accum._window_accumulate_cuda(*args), 50),
            "device_ms": graph_ms(lambda: window_accum._window_accumulate_cuda(*args)),
            "plain_ms": cuda_ms(lambda: window_accum._window_accumulate_plain(*args[:5]), 20),
            "library_ms": cuda_ms(library_b4, 50), "library_device_ms": graph_ms(library_b4),
            "library": "index_add_ of the live taps' rows (the plain "
            "version's core, without its masking)",
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": err.max().item(),
            "modeled_global_atomics": atomics, "modeled_per_tap_atomics": n_live * k4,
            "modeled_atomics_fall": n_live * k4 / max(atomics, 1),
        }
        emit({"phase": "B4 vs plain", "image": image, **rec})
        return rec

    def b4_vs_plain(image, sv, svi, svt, stex, idx) -> dict:
        n, hh, ww = idx.shape
        t_h, t_w = stex.shape[2:]
        fg = idx >= 0
        with torch.no_grad():
            _, bary0 = tt.render(sv, svi, idx)
            uv = tt.interpolate(svt, svi, idx, bary0).movedim(1, -1) * 2.0 - 1.0
        bx = torch.floor(gs._compute_source_index(uv[..., 0], t_w, "border", False)).int().clamp(0, t_w - 1)
        by = torch.floor(gs._compute_source_index(uv[..., 1], t_h, "border", False)).int().clamp(0, t_h - 1)
        k4 = 4 * stex.shape[1]  # the quad table's rows
        cot = torch.randn((n, hh * ww, k4), generator=gen, device=dev) * fg.reshape(n, -1, 1)  # zero at background
        iy = torch.where(fg, by, -1).reshape(n, -1)
        ix = bx.reshape(n, -1)
        return b4_record(image, (cot.transpose(1, 2), iy, ix, t_h, t_w, (hh, ww)))  # the [N, K, P] view

    b4 = b4_vs_plain("textured", v, vi, vt, tex, index_img)

    # M1 against the composite (mipmap_grid_sample with impl="plain") on the
    # arguments of one path's forward and backward launches, captured by a
    # stand-in for mipmap_grid_sample._m1_cuda: the output, the grid's
    # gradient and each level's, within 1e-5 of their largest magnitudes.
    # Bound, the bytes the function must move: per pixel the grid (8 B) and
    # the Jacobian (16 B) read and the output (4C B) written forward; the
    # cotangent (4C B), the grid and the Jacobian read and the grid's
    # gradient (8 B) written backward; the levels read once each way and
    # their gradients written once.
    def capture_m1(fn) -> tuple:
        """(forward arguments, the backward's cotangent) of the first M1
        launch pair that ``fn`` makes."""
        calls, launch = [], mipmap_mod._m1_cuda

        def m1_spy(*args, **kwargs):
            calls.append(args)
            return launch(*args, **kwargs)

        mipmap_mod._m1_cuda = m1_spy
        try:
            fn()
        finally:
            mipmap_mod._m1_cuda = launch
        fwd = next(c for c in calls if len(c) == 4)
        bwd = next(c for c in calls if len(c) > 4)
        return fwd, bwd[4]

    def m1_record(label, fwd, cot) -> dict:
        levels, grid, jac, opts = fwd
        max_aniso, pad, force, clip = opts

        def composite(lv=levels, g=cot):
            lv = [x.detach().requires_grad_() for x in lv]
            gr = grid.detach().requires_grad_()
            out = tt.mipmap_grid_sample(lv, gr, jac, max_aniso, "bilinear", pad, force_max_aniso=force,
                                        clip_grad=clip, impl="plain")
            return (out.detach(), *torch.autograd.grad(out, [gr, *lv], g))

        got = mipmap_mod._m1_cuda(levels, grid, jac, opts)
        got_grid, got_levels = mipmap_mod._m1_cuda(levels, grid, jac, opts, cot)
        want = composite()
        summed = composite([x.abs() for x in levels], cot.abs())
        errs = {"forward": ((got - want[0]).abs().max() / summed[0].abs().max()).item(),
                "grid": rel_err(got_grid, want[1]),
                **{f"levels[{i}]": ((g - w).abs().max() / s.abs().max().clamp(min=1e-30)).item()
                   for i, (g, w, s) in enumerate(zip(got_levels, want[2:], summed[2:]))}}
        if not all(e <= 1e-5 for e in errs.values()):
            raise AssertionError(f"M1 {label}: differs from the composite by {errs} of the largest magnitudes")
        del want, summed
        with tt.tracing.Tracer() as tracer:
            mipmap_mod._m1_cuda(levels, grid, jac, opts, cot)
        counts = tracer.snapshot()["counts"]
        n, c, hh, ww = got.shape
        level_bytes = sum(x[:1].numel() if x.stride(0) == 0 else x.numel() for x in levels) * 4
        fwd_bytes = n * hh * ww * (8 + 16 + 4 * c) + level_bytes
        bwd_bytes = n * hh * ww * (4 * c + 8 + 16 + 8) + level_bytes + sum(x.numel() for x in got_levels) * 4
        rec = {
            "output": list(got.shape), "levels": [list(x.shape) for x in levels], "max_aniso": max_aniso,
            "padding_mode": pad, "clip_grad": clip, "force_max_aniso": force,
            "ms": cuda_ms(lambda: mipmap_mod._m1_cuda(levels, grid, jac, opts), 20),
            "device_ms": graph_ms(lambda: mipmap_mod._m1_cuda(levels, grid, jac, opts)),
            "bwd_ms": cuda_ms(lambda: mipmap_mod._m1_cuda(levels, grid, jac, opts, cot), 20),
            "bwd_device_ms": graph_ms(lambda: mipmap_mod._m1_cuda(levels, grid, jac, opts, cot)),
            "plain_ms": cuda_ms(composite, 3, warmup=1),
            "bytes": fwd_bytes, "bound_ms": fwd_bytes / bw * 1e3, "bwd_bytes": bwd_bytes,
            "bwd_bound_ms": bwd_bytes / bw * 1e3, "rel_err": errs,
            "window_adds": counts.get("M1 window_adds"), "fallback_adds": counts.get("M1 fallback_adds"),
        }
        emit({"phase": "M1 vs composite", "input": label, **rec})
        return rec

    # E1 vs plain, on the arguments of the launches a path makes (captured by
    # a stand-in for edge_grad._e1_cuda): verts mode as the backward calls it
    # and image mode (edge_grad_image's) on the same inputs, each at
    # max_dp_dr 1e4 and 0; the textured input also in float64. Each must be
    # within 1e-5 (f64: 1e-12) of the plain version's largest magnitude,
    # and image mode must give its nonzero pixels (verts mode's nonzero
    # vertices are printed: a sum may cancel to 0 in one order). Bound,
    # the bytes the function must move with this run's data: the index once
    # (4 B a pixel) and the output once (verts: [N, V, 3]; image: [N, 3, H,
    # W]); img and the cotangent (C values each) and, in verts mode, bary
    # (3) at the pixels that receive a nonzero part (each is an end of a
    # contributing stencil leg, so reading them is the least the image reads
    # can be); the vertex ids and corners of the faces of those pixels.
    def capture_e1(fn) -> list:
        captured, launch = [], edge_grad_mod._e1_cuda

        def e1_spy(*args, **kwargs):
            captured.append(args)
            return launch(*args, **kwargs)

        edge_grad_mod._e1_cuda = e1_spy
        try:
            fn()
        finally:
            edge_grad_mod._e1_cuda = launch
        return captured

    def e1_plain(args):
        v_pix, svi, idx, img, g, bary = args[:6]
        if bary is not None:
            return edge_grad_mod._verts_plain(*args[:9])
        return edge_grad_mod._stencil_plain(_stencil_table(v_pix, svi), idx, img, g, None, *args[6:9])

    def e1_parts(args) -> torch.Tensor:
        """The pixels that receive a nonzero part (the plain image mode's
        nonzero foreground pixels), [N, H, W] bool."""
        v_pix, svi, idx, img, g = args[:5]
        image = edge_grad_mod._stencil_plain(_stencil_table(v_pix, svi), idx, img, g, None, *args[6:9])
        return (image != 0).any(1) & (idx >= 0)

    def e1_bound(args) -> tuple[int, float, float]:
        """(bytes, bound ms, parts' pixels) of E1 on these arguments."""
        v_pix, svi, idx, img, g, bary = args[:6]
        n, c, h, w = img.shape
        es = v_pix.element_size()
        parts = e1_parts(args)
        n_parts = int(parts.sum())
        faces = int(torch.unique(idx[parts].long().clamp(max=svi.shape[1] - 1)
                                 + torch.nonzero(parts)[:, :1].squeeze(1) * svi.shape[1]).numel())
        out_bytes = v_pix.shape[0] * v_pix.shape[1] * 3 * es if bary is not None else n * 3 * h * w * es
        nbytes = (n * h * w * 4 + out_bytes + n_parts * (2 * c + (3 if bary is not None else 0)) * es
                  + faces * (12 + 9 * es))
        return nbytes, nbytes / bw * 1e3, n_parts

    def e1_record(args, timed: bool) -> dict:
        v_pix, bary = args[0], args[5]
        got = edge_grad_mod._e1_cuda(*args[:9])
        want = e1_plain(args)
        torch.cuda.synchronize()
        nonzero = (lambda t: t != 0) if bary is not None else (lambda t: (t != 0).any(1))
        nz_got, nz_want = nonzero(got), nonzero(want)
        rec = {"max_abs_err": (got - want).abs().max().item(), "rel_err": rel_err(got, want),
               "nonzero": int(nz_want.sum()), "nonzero_equal": bool(torch.equal(nz_got, nz_want)),
               "nonzero_mismatch": int((nz_got != nz_want).sum())}
        limit = 1e-12 if v_pix.dtype == torch.float64 else 1e-5
        # Image mode: the classes decide which pixels are nonzero, so they must
        # match. Verts mode: a vertex's sum may cancel to exactly 0 in one
        # order of the additions and not in the other; the limit bounds it.
        if not ((rec["nonzero_equal"] or bary is not None) and rec["rel_err"] <= limit and bool(nz_want.any())):
            raise AssertionError(f"E1 {[tuple(a.shape) if torch.is_tensor(a) else a for a in args]}: {rec}, "
                                 f"limit {limit}")
        if timed:
            nbytes, bound_ms, n_parts = e1_bound(args)
            rec.update({
                "ms": cuda_ms(lambda: edge_grad_mod._e1_cuda(*args[:9]), 50),
                "device_ms": graph_ms(lambda: edge_grad_mod._e1_cuda(*args[:9])),
                "plain_ms": cuda_ms(lambda: e1_plain(args), 10),
                "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
                "part_pixels": n_parts,
            })
            if bary is not None:  # E1 alone, adding into one accumulator: without the output's zeros
                acc = torch.zeros_like(got)
                rec["kernel_device_ms"] = graph_ms(lambda: edge_grad_mod._e1_cuda(*args[:9], out=acc))
        return rec

    def e1_vs_plain(label, args, f64=False, timed=True) -> dict:
        """E1 against its plain version on one launch's arguments (v_pix, vi,
        index, img, cotangent, bary, max_dp_dr, y_offset, full_height)."""
        v_pix, svi, idx, img, g, bary, _, y0, frame_h = args[:9]
        recs = {}
        for mode in ("verts", "image"):
            for m in (1e4, 0.0):
                recs[f"{mode} max_dp_dr={m:g}"] = e1_record(
                    (v_pix, svi, idx, img, g, bary if mode == "verts" else None, m, y0, frame_h), timed and m > 0)
        if f64:
            recs["verts max_dp_dr=10000 float64"] = e1_record(
                (v_pix.double(), svi, idx, img.double(), g.double(), bary.double(), 1e4, y0, frame_h), timed=True)
        n, c, h, w = img.shape
        emit({"phase": "E1 vs plain", "input": label, "batch": n, "channels": c, "H": h, "W": w,
              "vertices": int(v_pix.shape[1]), "faces": int(svi.shape[1]), "y_offset": y0, "full_height": frame_h,
              "discontinuity_pixels": int(((idx[:, :-1, :-1] != idx[:, :-1, 1:])
                                           | (idx[:, :-1, :-1] != idx[:, 1:, :-1])).sum()), **recs})
        return recs

    def e1_contention(args) -> dict:
        """The atomics E1's verts mode makes on these arguments, modeled:
        9 per pixel that receives a part (fewer where a value is 0), and how
        many of a warp's 32 pixels (a tile row) send to one face."""
        svi, idx = args[1], args[2]
        _, h, w = idx.shape
        parts = e1_parts(args)
        at = torch.nonzero(parts)
        f_cnt = svi.shape[1]
        warp = (at[:, 0] * h + at[:, 1]) * ((w + 31) // 32) + at[:, 2] // 32
        _, lanes = torch.unique(warp * f_cnt + idx[parts].long().clamp(max=f_cnt - 1), return_counts=True)
        return {"part_pixels": int(parts.sum()), "modeled_atomics_at_most": 9 * int(parts.sum()),
                "same_face_lanes_max": int(lanes.max()), "same_face_lanes_mean": lanes.float().mean().item()}

    def backward_launches(label, fn, e1_launches) -> dict:
        """``fn`` (an edge_grad backward on CUDA tensors) under torch.profiler:
        it must launch E1 ``e1_launches`` times and no other kernel of the
        port, call no ``index_add_``, and run no device operation but those
        launches and the output's zeros."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = tt.kernel_launch_counts()
        cpu_ops = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CPU})
        device_ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        rec = {"phase": "edge_grad backward", "path": label, "launches": launches, "device_ops": device_ops,
               "index_add_called": "aten::index_add_" in cpu_ops, "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if (launches != {**{k: 0 for k in launches}, "E1 edge_grad": e1_launches} or rec["index_add_called"]
                or (device_ops and len(device_ops) != e1_launches + 1)):
            raise AssertionError(f"edge_grad backward {label}: {rec}, expected E1 {e1_launches} times, no other "
                                 "kernel of the port, no index_add_, and besides E1 only the output's zeros")
        emit(rec)
        return rec

    # 8. The main path of this slice: the fitting step at full size, with
    # gradients to v, vt and tex, then bench_textured's v-only gradient.
    expected = {
        ("v", "vt", "tex"): {"B1 rasterize": 1, "B2 gather_rows": 2, "B3 scatter_rows": 1, "B4 window_accum": 1,
                             "B5 rasterize_lines": 0, "E1 edge_grad": 1, "M1 mipmap_sample": 0, "R1 render": 2},
        ("v",): {"B1 rasterize": 1, "B2 gather_rows": 2, "B3 scatter_rows": 0, "B4 window_accum": 0,
                 "B5 rasterize_lines": 0, "E1 edge_grad": 1, "M1 mipmap_sample": 0, "R1 render": 2},
    }
    fit = {}
    for wrt, per_step in expected.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        step_marks, host_s = [], []
        for _ in range(WARMUP + STEPS):
            marks = []
            t0 = time.perf_counter()
            loss, grads = fit_step(v, vi, vt, tex, H, W, wrt=wrt, stage_times=marks)
            host_s.append(time.perf_counter() - t0)
            step_marks.append(marks)
        torch.cuda.synchronize()
        fit_launches = tt.kernel_launch_counts()
        n_steps = WARMUP + STEPS
        if fit_launches != {k: c * n_steps for k, c in per_step.items()}:
            raise AssertionError(f"fit step {wrt}: launches {fit_launches} over {n_steps} steps, expected "
                                 f"{per_step} per step")
        peak = torch.cuda.max_memory_allocated()
        per_stage = [stage_ms(marks) for marks in step_marks[WARMUP:]]
        step_ms = [sum(p.values()) for p in per_stage]
        fwd_ms = [sum(p[k] for k in STAGES + ("loss",)) for p in per_stage]
        med_ms = statistics.median(step_ms)
        for leaf, g in grads.items():
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"fit step {wrt}: grad_{leaf} is not finite")
        profile = device_profile(lambda wrt=wrt: fit_step(v, vi, vt, tex, H, W, wrt=wrt), PROFILED_STEPS)
        fit[wrt] = {
            "phase": "fit step", "config": "textured", "wrt": list(wrt), "H": H, "W": W, "faces": n_faces,
            "steps_timed": STEPS, "step_ms_median": med_ms, "step_ms_min": min(step_ms),
            "step_ms_max": max(step_ms), "mpix_per_s": H * W / (med_ms * 1e-3) / 1e6,
            "forward_ms_median": statistics.median(fwd_ms),
            "backward_ms_median": statistics.median(sum(p[k] for k in BACKWARD_STAGES) for p in per_stage),
            "host_ms_per_call_median": statistics.median(host_s[WARMUP:]) * 1e3,
            "stage_ms_median": {k: statistics.median(p[k] for p in per_stage) for k in FIT_STAGES},
            "peak_mem_bytes": peak, "launches": fit_launches, "launches_per_step": per_step,
            "loss": loss.item(), "profile": profile,
        }
    main_launches = fit[("v", "vt", "tex")]["launches"]

    # ...held against the plain pipeline on the kernel's index image.
    idx_k = tt.rasterize(v, vi, H, W)
    loss_k, grads_k = fit_step(v, vi, vt, tex, H, W, index_img=idx_k)
    loss_p, grads_p = fit_step(v, vi, vt, tex, H, W, index_img=idx_k, impl="plain")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if loss_err > 1e-5:
        raise AssertionError(f"fit step: loss differs from the plain pipeline's by {loss_err} relative")
    grad_err = {}
    for leaf in ("v", "vt", "tex"):
        scale = grads_p[leaf].abs().max().item()
        grad_err[leaf] = (grads_k[leaf] - grads_p[leaf]).abs().max().item() / scale
        if not grad_err[leaf] <= 1e-4:
            raise AssertionError(f"fit step: grad_{leaf} differs from the plain pipeline's by {grad_err[leaf]} "
                                 "of its largest magnitude")
    fit[("v", "vt", "tex")].update({"loss_rel_err_vs_plain": loss_err, "grad_rel_err_vs_plain": grad_err})
    for rec in fit.values():
        emit(rec)
    peaks.update({f"fit step {'+'.join(wrt)}": r["peak_mem_bytes"] for wrt, r in fit.items()})
    (e1_args,) = capture_e1(lambda: fit_step(v, vi, vt, tex, H, W, index_img=idx_k))
    e1 = {"textured": e1_vs_plain("textured fitting step", e1_args, f64=True)}

    # ...the step's edge_grad backward alone: one E1 launch and the output's
    # zeros, no B3, no index_add_.
    def fit_edge_grad_backward(a=e1_args):
        vv = a[0].detach().requires_grad_()
        return torch.autograd.grad(tt.edge_grad_estimator(vv, a[1], a[5], a[3], a[2]), vv, a[4])

    eg_bwd = {"fit_step": backward_launches("fitting step, full frame", fit_edge_grad_backward, 1)}
    del e1_args, fit_edge_grad_backward  # its default holds the step's image, cotangent and bary

    # ...and E1 where atomics meet: the entry scene (128 large triangles at
    # 256^2), where along a silhouette the lanes of a warp add into the same
    # face's 9 addresses; the modeled same-face lanes per warp.
    ent_v, ent_vi = entry[0], rast.broadcast_vi(entry[1], 1)
    with torch.no_grad():
        ent_idx = tt.rasterize(ent_v, ent_vi, ENTRY_HW, ENTRY_HW)
        _, ent_bary = tt.render(ent_v, ent_vi, ent_idx)
    ent_args = (ent_v, ent_vi, ent_idx, torch.rand((1, 3, ENTRY_HW, ENTRY_HW), generator=gen, device=dev),
                torch.randn((1, 3, ENTRY_HW, ENTRY_HW), generator=gen, device=dev), ent_bary, 1e4, 0, -1)
    e1["entry"] = e1_vs_plain("entry", ent_args)
    emit({"phase": "E1 contention", "input": "entry", **e1_contention(ent_args),
          "device_ms": e1["entry"]["verts max_dp_dr=10000"]["kernel_device_ms"],
          "bound_ms": e1["entry"]["verts max_dp_dr=10000"]["bound_ms"]})

    # 10. B5 vs plain, every edge visible: the entry scene (canvas-sized
    # triangles), the textured scene, the inverse8 views through transform,
    # and the near-miss scene (edges at a diamond's reach and along its
    # sides, to within ulps); bit for bit.
    inv = scene_from_numpy(inverse8_scene_arrays(INV_HW, INV_GN, INV_VIEWS), dev)
    cams = {k: inv[k] for k in CAMS}
    inv_vi_wire = torch.from_numpy(with_edge_flags(inv["vi"].cpu().numpy())).to(dev)
    with torch.no_grad():
        inv_v_pix = tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams)
    vi_wire = torch.from_numpy(with_edge_flags(vi.cpu().numpy())).to(dev)
    near = near_miss_scene()
    b5 = {}
    for scene, (sv, svi, hh, ww) in {
        "entry": (entry[0], torch.from_numpy(with_edge_flags(entry[1].cpu().numpy())).to(dev), ENTRY_HW, ENTRY_HW),
        "textured": (v, vi_wire, H, W),
        "inverse8": (inv_v_pix, inv_vi_wire, INV_HW, INV_HW),
        "near_miss": (torch.from_numpy(near["v"]).to(dev), torch.from_numpy(with_edge_flags(near["vi"])).to(dev),
                      64, 128),
    }.items():
        svib = rast.broadcast_vi(svi, sv.shape[0])
        setup, lines = rast.triangle_setup(sv, svib), rast.line_setup(sv, svib)
        valid = rast._canvas_cull(setup, hh, ww)
        rows, meta, ends = rasterize_cuda.pack_lines(setup, lines, valid, hh, ww, 0, hh)
        d, i = rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww)
        d_ref, i_ref = rast._rasterize_lines_plain(setup, lines, valid, hh, ww, 0, hh)
        torch.cuda.synchronize()
        rec = check_raster(f"B5 {scene}", d_ref, i_ref, d, i)
        if not (torch.equal(d, d_ref) and torch.equal(i, i_ref)):
            raise AssertionError(f"B5 {scene}: kernel not bit-identical to the plain wireframe resolve")
        if not bool((i >= 0).any()):
            raise AssertionError(f"B5 {scene}: no pixel indexed")
        m = meta.long()
        area = (m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)
        n_vis = ((m[..., 0] >> 3) & 1) + ((m[..., 0] >> 4) & 1) + ((m[..., 0] >> 5) & 1)
        tests = int(ends[-1])
        full_flops = int((area * (LINE_FLOPS_PER_TEST + LINE_FLOPS_PER_EDGE * n_vis)).sum())
        nbytes = rows.numel() * 4 + meta.numel() * 4 + ends.numel() * 8 + d.numel() * LINE_BYTES_PER_PIXEL
        key_bytes = d.numel() * LINE_KEY_BYTES_PER_PIXEL
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = tests * LINE_FLOOR_FLOPS_PER_TEST / f32_flops * 1e3
        model = modeled_edge_tests(rows, meta, ends)
        ms_runs = [cuda_ms(lambda: rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww), 20)
                   for _ in range(3)]
        rec.update({
            "H": hh, "W": ww, "batch": int(sv.shape[0]), "faces": int(svib.shape[1]), "bit_exact": True,
            "indexed_pixels": int((i >= 0).sum()), "depth_only_pixels": int(((i < 0) & (d > 0)).sum()),
            "ms": statistics.median(ms_runs), "ms_runs": ms_runs,
            "device_ms": graph_ms(lambda: rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww)),
            "plain_ms": cuda_ms(lambda: rast._rasterize_lines_plain(setup, lines, valid, hh, ww, 0, hh), 2, warmup=1),
            "rasterize_call_ms": cuda_ms(lambda: tt.rasterize_with_depth(sv, svi, hh, ww, wireframe=True), 20),
            "pixel_tests": tests, "flops": tests * LINE_FLOOR_FLOPS_PER_TEST, "bytes": nbytes,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "full_test_flops": full_flops, "full_test_ops_ms": full_flops / f32_flops * 1e3, "library_ms": None,
            "key_buffer_bytes": key_bytes, "key_buffer_ms": key_bytes / bw * 1e3,
            # a model from the packed rows (modeled_edge_tests), not a count from the kernel
            "modeled_edge_tests_per_pixel": {
                "before_reject": model["visible"], "after_box": model["edges_box"],
                "after_box_and_line": model["edges_line"], "queued_by_kernel": model["edges_queued"],
                "side_tests_after_box_and_line": model["sides_line"]},
        })
        b5[scene] = rec
        emit({"phase": "B5 vs plain", "scene": scene, **rec})

    # 11. Row-tile viewports on the textured scene: H/4-row tiles from B1 and
    # B5 equal the full frame's rows bit for bit, and their plain versions.
    viewport = {}
    for mode, (svi, wire) in {"B1": (vi, False), "B5": (vi_wire, True)}.items():
        d_full, i_full = tt.rasterize_with_depth(v, svi, H, W, wireframe=wire)
        tiles = []
        for y0 in range(0, H, H // 4):
            kw = dict(wireframe=wire, y_offset=y0, full_height=H)
            d_t, i_t = tt.rasterize_with_depth(v, svi, H // 4, W, **kw)
            d_p, i_p = tt.rasterize_with_depth(v, svi, H // 4, W, impl="plain", **kw)
            torch.cuda.synchronize()
            if not (torch.equal(i_t, i_full[:, y0 : y0 + H // 4]) and torch.equal(d_t, d_full[:, y0 : y0 + H // 4])):
                raise AssertionError(f"viewport {mode} y_offset={y0}: the tile differs from the full frame's rows")
            exact = bool(torch.equal(d_t, d_p) and torch.equal(i_t, i_p))
            if mode == "B1" and not exact:
                raise AssertionError(f"viewport B1 y_offset={y0}: the tile is not bit-identical to the plain one")
            tiles.append({"y_offset": y0, **check_raster(f"viewport {mode} {y0} vs plain", d_p, i_p, d_t, i_t),
                          "bit_exact_vs_plain": exact})
        viewport[mode] = tiles
    emit({"phase": "viewport", "scene": "textured", "rows": H // 4, "tiles_equal_full_frame": True, **viewport})

    # 12. The wireframe path: every inverse8 view, transform then
    # rasterize(wireframe=True), through the public entry points.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_kernel_launch_counts()
    with torch.no_grad():
        wire_idx = tt.rasterize(tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams), inv_vi_wire,
                                INV_HW, INV_HW, wireframe=True)
    torch.cuda.synchronize()
    wire_launches = tt.kernel_launch_counts()
    peaks["wireframe path"] = torch.cuda.max_memory_allocated()
    if wire_launches != {**{k: 0 for k in wire_launches}, "B5 rasterize_lines": 1}:
        raise AssertionError(f"wireframe path: launches {wire_launches}, expected B5 once")
    if wire_idx.shape != (INV_VIEWS, INV_HW, INV_HW) or not bool((wire_idx >= 0).flatten(1).any(1).all()):
        raise AssertionError("wireframe path: a view with no indexed pixel, or the wrong shape")
    with torch.no_grad():
        wire_ms = cuda_ms(lambda: tt.rasterize(tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams),
                                               inv_vi_wire, INV_HW, INV_HW, wireframe=True), 20)
    emit({"phase": "wireframe path", "config": "inverse8", "views": INV_VIEWS, "H": INV_HW, "W": INV_HW,
          "launches": wire_launches, "ms": wire_ms, "peak_mem_bytes": peaks["wireframe path"], "indexed_share": (wire_idx >= 0).float().mean().item()})

    # 13. The main path of this slice: the inverse8 training step at full
    # size (8 views of 512^2, 12,800 triangles, a 3x256x256 texture, Adam
    # lr 1e-3), from bench.py's start: the vertices moved by 0.02 and a grey
    # texture, against the image rendered once from the true ones through
    # the same cameras; then held against the plain pipeline on the kernel's
    # index image, each side from a copy of the current parameters with an
    # optimizer of its own. Phase 16 runs it through lenses.
    inv_per_step = {"B1 rasterize": 1, "B2 gather_rows": 2, "B3 scatter_rows": 0, "B4 window_accum": 1,
                    "B5 rasterize_lines": 0, "E1 edge_grad": 1, "M1 mipmap_sample": 0, "R1 render": 2}

    def multiview_step(label, step_cams, steps, e1_timed=False) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """The step's record, and the current vertices in pixel space and
        their index image (the kernel's); E1 held against its plain version
        on the step's own launch (``e1[label]``)."""
        t_phase = time.perf_counter()
        with torch.no_grad():
            gt, _ = render_multiview(inv["v_world"], inv["vi"], inv["vt"], inv["tex_gt"], step_cams, INV_HW, INV_HW)
        params = ((inv["v_world"] + 0.02).requires_grad_(), torch.full_like(inv["tex_gt"], 0.5).requires_grad_())
        opt = torch.optim.Adam(params, lr=1e-3)
        args = (inv["vi"], inv["vt"], step_cams, gt, INV_HW, INV_HW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        marks_all, host_s, losses = [], [], []
        for _ in range(WARMUP + steps):
            marks = []
            t0 = time.perf_counter()
            loss, grads = inverse8_step(params, opt, *args, stage_times=marks)
            host_s.append(time.perf_counter() - t0)
            marks_all.append(marks)
            losses.append(loss)
        torch.cuda.synchronize()
        launches = tt.kernel_launch_counts()
        if launches != {k: c * (WARMUP + steps) for k, c in inv_per_step.items()}:
            raise AssertionError(f"{label}: launches {launches} over {WARMUP + steps} steps, expected {inv_per_step} "
                                 "per step")
        peak = peaks[label] = torch.cuda.max_memory_allocated()
        losses = [x.item() for x in losses]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{label}: the loss went from {losses[0]} to {losses[-1]}")
        for leaf, g in grads.items():
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: grad_{leaf} is not finite")
        per_stage = [stage_ms(m) for m in marks_all[WARMUP:]]
        step_ms = [sum(p.values()) for p in per_stage]
        med_ms = statistics.median(step_ms)
        fwd_stages = INVERSE8_STAGES[: INVERSE8_STAGES.index("loss") + 1]
        profile = device_profile(lambda: inverse8_step(params, opt, *args), PROFILED_STEPS)
        with torch.no_grad():
            v_pix = tt.transform(params[0].expand(INV_VIEWS, -1, -1), **step_cams)
        idx = tt.rasterize(v_pix, inv["vi"], INV_HW, INV_HW)
        side = {}
        for impl in ("auto", "plain"):
            p = tuple(t.detach().clone().requires_grad_() for t in params)
            e1_args = capture_e1(lambda p=p, impl=impl: side.update({impl: inverse8_step(
                p, torch.optim.Adam(p, lr=1e-3), *args, index_img=idx, impl=impl)}))
            if len(e1_args) != (impl == "auto"):
                raise AssertionError(f"{label}: {len(e1_args)} E1 launches with impl={impl!r}")
            if e1_args:
                e1[label] = e1_vs_plain(label, e1_args[0], timed=e1_timed)
        del e1_args
        (loss_k, grads_k), (loss_p, grads_p) = side["auto"], side["plain"]
        loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        grad_err = {leaf: rel_err(grads_k[leaf], grads_p[leaf]) for leaf in ("v_world", "tex")}
        if loss_err > 1e-5 or not all(e <= 1e-4 for e in grad_err.values()):
            raise AssertionError(f"{label}: the step differs from the plain pipeline's (loss {loss_err} relative, "
                                 f"gradients {grad_err} of their largest magnitude)")
        fov = step_cams.get("fov")
        rec = {
            "phase": label, "config": "inverse8", "distortion_mode": step_cams.get("distortion_mode"),
            "fov": None if fov is None else fov.flatten().tolist(), "views": INV_VIEWS, "H": INV_HW, "W": INV_HW,
            "faces": int(inv["vi"].shape[0]), "steps_timed": steps, "step_ms_median": med_ms,
            "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
            "mpix_per_s": INV_VIEWS * INV_HW * INV_HW / (med_ms * 1e-3) / 1e6,
            "forward_ms_median": statistics.median(sum(p[k] for k in fwd_stages) for p in per_stage),
            "backward_ms_median": statistics.median(
                sum(p[k] for k in BACKWARD_STAGES + ("transform_bwd",)) for p in per_stage),
            "host_ms_per_call_median": statistics.median(host_s[WARMUP:]) * 1e3,
            "stage_ms_median": {k: statistics.median(p[k] for p in per_stage) for k in INVERSE8_STAGES},
            "device_busy_ms_per_step": profile["device_busy_ms_per_step"] if profile else None,
            "peak_mem_bytes": peak, "launches": launches, "launches_per_step": inv_per_step,
            "loss_first": losses[0], "loss_last": losses[-1], "culled_vertices": int((v_pix[..., 2] == -1).sum()),
            "coverage": (idx >= 0).float().mean().item(), "loss_rel_err_vs_plain": loss_err,
            "grad_rel_err_vs_plain": grad_err, "profile": profile, "phase_seconds": time.perf_counter() - t_phase,
        }
        emit(rec)
        return rec, v_pix, idx

    inv_rec, inv_v_pix, idx_k = multiview_step("inverse8 step", cams, STEPS, e1_timed=True)
    inv_launches = inv_rec["launches"]
    # ...and the near-miss scene (edges at a pixel diamond's reach, to within
    # ulps), a seeded image and cotangent of 4 channels.
    nm_v = torch.from_numpy(near["v"]).to(dev)
    nm_vi = rast.broadcast_vi(torch.from_numpy(near["vi"]).to(dev), 1)
    with torch.no_grad():
        nm_idx = tt.rasterize(nm_v, nm_vi, 64, 128)
        _, nm_bary = tt.render(nm_v, nm_vi, nm_idx)
    nm_img = torch.rand((1, 4, 64, 128), generator=gen, device=dev)
    nm_g = torch.randn((1, 4, 64, 128), generator=gen, device=dev)
    e1["near_miss"] = e1_vs_plain("near_miss", (nm_v, nm_vi, nm_idx, nm_img, nm_g, nm_bary, 1e4, 0, -1))
    # ...its B1 launch held against the plain rasterizer on the same views
    # (8 x 512^2, 12,800 triangles each).
    b1["inverse8"] = b1_vs_plain("inverse8", inv_v_pix, inv["vi"], INV_HW, INV_HW)

    # 13b. B2 vs plain on the inverse8 step's index image: 8 views of 512^2,
    # tables of 12,800 rows per view, the batch on blockIdx.y.
    inv_vib = rast.broadcast_vi(inv["vi"], INV_VIEWS)
    b2_inv = b2_vs_plain("inverse8", {
        9: _face_table(inv_v_pix, inv_vib),
        6: _face_table(inv["vt"].expand(INV_VIEWS, -1, -1), inv_vib),
        16: torch.from_numpy(rng.randn(INV_VIEWS, inv_vib.shape[1], 16).astype(np.float32)).to(dev),
    }, idx_k)

    # 13c. B3 and B4 vs plain on the inverse8 step's index image and taps:
    # 8 views of 512^2, 12,800 faces, the 3x256x256 texture.
    b3_inv = b3_vs_plain("inverse8", idx_k, int(inv["vi"].shape[0]))
    b4_inv = b4_vs_plain("inverse8", inv_v_pix, inv["vi"], inv["vt"].expand(INV_VIEWS, -1, -1), inv["tex_gt"], idx_k)

    # 16. The inverse8 step through a lens: every camera given a Fisheye62
    # lens (scenes.INVERSE8_LENSES, jittered per view), its fov estimated once
    # on the host before the steps, so that no step waits for the host; then
    # a per-view list of pinhole, radial-tangential and fisheye lenses.
    fish_coeff = torch.from_numpy(inverse8_lens_arrays("fisheye62", INV_VIEWS)).to(dev)
    fish, _, _ = multiview_step("fisheye62 step", {**cams, "distortion_mode": "fisheye62",
                                                   "distortion_coeff": fish_coeff,
                                                   "fov": tt.utils.estimate_fisheye62_fov(fish_coeff)}, STEPS)
    mixed_modes = [LENS_LIST[i % len(LENS_LIST)] for i in range(INV_VIEWS)]
    mixed_coeff = torch.from_numpy(inverse8_lens_arrays(mixed_modes, INV_VIEWS)).to(dev)
    mixed_fov = torch.cat([  # each row's own estimator; a pinhole row reads none
        tt.utils.estimate_rt_fov(mixed_coeff[i : i + 1]) if m == "radial-tangential"
        else tt.utils.estimate_fisheye_fov(mixed_coeff[i : i + 1]) for i, m in enumerate(mixed_modes)])
    mixed, _, _ = multiview_step("lens list step", {**cams, "distortion_mode": mixed_modes,
                                                    "distortion_coeff": mixed_coeff, "fov": mixed_fov}, LENS_LIST_STEPS)

    # 17. Mipmapped views: the 8 inverse8 views shaded as examples/04 shades,
    # the analytic uv Jacobian (screen_space_uv_derivative, B2 on its 3F-vertex
    # tables of 3 x 6 and 3 x 3 floats per face) driving mipmap_grid_sample
    # (max_aniso 4, border) of a 4-level box pyramid of the 3x256^2 texture;
    # forward and backward of sum(img * w) to the world vertices and the levels.
    t_phase = time.perf_counter()
    mv_levels = [torch.from_numpy(x).to(dev) for x in box_pyramid(inv["tex_gt"].cpu().numpy(), 4)]
    mv_w = torch.randn((INV_VIEWS, 4, INV_HW, INV_HW), generator=gen, device=dev)
    mv_per_call = {"B1 rasterize": 1, "B2 gather_rows": 4, "B3 scatter_rows": 0, "B4 window_accum": 0,
                   "B5 rasterize_lines": 0, "E1 edge_grad": 1, "M1 mipmap_sample": 2, "R1 render": 2}

    def mipmap_views(impl="auto", index_img=None, ev=None):
        vw = inv["v_world"].detach().requires_grad_()
        lv = [x.detach().requires_grad_() for x in mv_levels]
        if ev:
            ev[0].record()
        out, idx = render_mipmap_multiview(vw, inv["vi"], inv["vt"], lv, cams, INV_HW, INV_HW, impl=impl,
                                           index_img=index_img)
        if ev:
            ev[1].record()
        loss = (out * mv_w).sum()
        grads = torch.autograd.grad(loss, [vw, *lv])
        if ev:
            ev[2].record()
        return out, loss.detach(), grads, idx

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_kernel_launch_counts()
    mv_events = []
    for _ in range(MV_WARMUP + MV_CALLS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        mv_img, mv_loss, mv_grads, mv_idx = mipmap_views(ev=ev)
        mv_events.append(ev)
    torch.cuda.synchronize()
    mv_launches = tt.kernel_launch_counts()
    if mv_launches != {k: c * (MV_WARMUP + MV_CALLS) for k, c in mv_per_call.items()}:
        raise AssertionError(f"mipmap views: launches {mv_launches}, expected {mv_per_call} per call")
    mv_peak = peaks["mipmap views"] = torch.cuda.max_memory_allocated()
    mv_fwd = [e[0].elapsed_time(e[1]) for e in mv_events[MV_WARMUP:]]
    mv_all = [e[0].elapsed_time(e[2]) for e in mv_events[MV_WARMUP:]]
    if mv_img.shape != (INV_VIEWS, 4, INV_HW, INV_HW) or not all(bool(torch.isfinite(x).all())
                                                                   for x in (mv_img, *mv_grads)):
        raise AssertionError("mipmap views: the image or a gradient is not finite, or the image has the wrong shape")
    mv_profile = device_profile(lambda: mipmap_views(), PROFILED_STEPS)
    # ...held against the plain pipeline on the kernel's index image, and B2
    # against its plain version on the uv derivative's tables.
    mv_side = {}
    m1_mv = m1_record("mipmap views", *capture_m1(lambda: mipmap_views("auto", mv_idx)))
    (mv_e1,) = capture_e1(lambda: mv_side.update(auto=mipmap_views("auto", mv_idx)))
    mv_side["plain"] = mipmap_views("plain", mv_idx)
    e1["mipmap views"] = e1_vs_plain("mipmap views", mv_e1, timed=False)
    del mv_e1
    mv_loss_err = rel_err(mv_side["auto"][1], mv_side["plain"][1])
    mv_grad_err = {name: rel_err(a, b) for name, a, b in zip(
        ["v_world"] + [f"levels[{i}]" for i in range(len(mv_levels))], mv_side["auto"][2], mv_side["plain"][2])}
    if mv_loss_err > 1e-5 or not all(e <= 1e-4 for e in mv_grad_err.values()):
        raise AssertionError(f"mipmap views: differ from the plain pipeline (loss {mv_loss_err}, gradients "
                             f"{mv_grad_err} of their largest magnitude)")
    with torch.no_grad():
        mv_v = inv["v_world"].expand(INV_VIEWS, -1, -1)
        dpdt, vf = face_dpdt(mv_v, inv["vt"].expand(INV_VIEWS, -1, -1), inv["vi"], inv["vi"])
        f3 = 3 * inv["vi"].shape[0]
        vi_dis = rast.broadcast_vi(torch.arange(f3, dtype=torch.int32, device=dev).reshape(-1, 3), INV_VIEWS)
        b2_mv = b2_vs_plain("mipmap views uv derivative", {
            18: _face_table(dpdt[:, :, None].expand(-1, -1, 3, -1, -1).reshape(INV_VIEWS, f3, 6), vi_dis),
            9: _face_table(vf.reshape(INV_VIEWS, f3, 3), vi_dis)}, mv_idx)
    emit({
        "phase": "mipmap views", "config": "inverse8", "views": INV_VIEWS, "H": INV_HW, "W": INV_HW,
        "levels": [list(x.shape) for x in mv_levels], "max_aniso": 4, "calls_timed": MV_CALLS,
        "forward_ms_median": statistics.median(mv_fwd), "step_ms_median": statistics.median(mv_all),
        "step_ms_min": min(mv_all), "step_ms_max": max(mv_all),
        "device_busy_ms_per_step": mv_profile["device_busy_ms_per_step"] if mv_profile else None,
        "peak_mem_bytes": mv_peak, "launches": mv_launches, "launches_per_call": mv_per_call,
        "coverage": (mv_idx >= 0).float().mean().item(), "loss_rel_err_vs_plain": mv_loss_err,
        "grad_rel_err_vs_plain": mv_grad_err, "m1_device_ms": m1_mv["device_ms"],
        "m1_bwd_device_ms": m1_mv["bwd_device_ms"], "profile": mv_profile,
        "phase_seconds": time.perf_counter() - t_phase,
    })
    del mv_side, mv_grads, mv_img

    # 18. grid_scatter: the textured scene's 1024^2 render scattered through
    # its own uv image into a 3x512^2 texture, bilinear/border and
    # bicubic/zeros: the forward is one B4 launch on the [T*H, W] tap grid,
    # held against its plain version on the captured taps (and index_add_);
    # the output against grid_scatter_ref in float64; the backward to the
    # input and the grid.
    with torch.no_grad():
        gs_in, gs_idx = render_textured(v, vi, vt, tex, H, W)
        _, gs_bary = tt.render(v, vi, gs_idx)
        gs_grid = tt.interpolate(vt, vi, gs_idx, gs_bary).movedim(1, -1) * 2.0 - 1.0
    gs_w = torch.randn((1, 3, GS_HW, GS_HW), generator=gen, device=dev)
    gs, b4_gs, gs_launches = {}, {}, {}
    for mode, pad in (("bilinear", "border"), ("bicubic", "zeros")):
        t_phase = time.perf_counter()

        def gs_fwd(mode=mode, pad=pad):
            return tt.grid_scatter(gs_in, gs_grid, GS_HW, GS_HW, mode, pad)

        def gs_step(mode=mode, pad=pad):
            x, g = gs_in.detach().requires_grad_(), gs_grid.detach().requires_grad_()
            return torch.autograd.grad((tt.grid_scatter(x, g, GS_HW, GS_HW, mode, pad) * gs_w).sum(), (x, g))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        fwd_ms = cuda_ms(gs_fwd, GS_CALLS)
        step_ms = cuda_ms(gs_step, GS_CALLS)
        torch.cuda.synchronize()
        launches = tt.kernel_launch_counts()
        if launches != {**{k: 0 for k in launches}, "B4 window_accum": 2 * (GS_CALLS + 2)}:
            raise AssertionError(f"grid_scatter {mode}: launches {launches}, expected B4 once per forward")
        peak = peaks[f"grid_scatter {mode}"] = torch.cuda.max_memory_allocated()
        profile = device_profile(gs_step, PROFILED_STEPS)
        captured, launch = [], window_accum._window_accumulate_cuda

        def b4_spy(*args):
            captured.append(args)
            return launch(*args)

        window_accum._window_accumulate_cuda = b4_spy
        try:
            out = gs_fwd()
        finally:
            window_accum._window_accumulate_cuda = launch
        b4_gs[mode] = b4_record(f"grid_scatter {mode} {pad}", captured[0])
        ref_err = rel_err(out.double(), tt.grid_scatter_ref(gs_in.double(), gs_grid.double(), GS_HW, GS_HW, mode, pad))
        grads = gs_step()
        if not ref_err <= 1e-5 or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"grid_scatter {mode}: differs from grid_scatter_ref by {ref_err} of its largest "
                                 "magnitude, or a gradient is not finite")
        gs_launches[mode] = launches
        gs[mode] = {
            "phase": "grid_scatter", "mode": mode, "padding_mode": pad, "input": list(gs_in.shape),
            "output": [GS_HW, GS_HW], "taps": captured[0][1].numel(), "live_taps": b4_gs[mode]["live_taps"],
            "calls_timed": GS_CALLS, "forward_ms": fwd_ms, "step_ms": step_ms,
            "device_busy_ms_per_step": profile["device_busy_ms_per_step"] if profile else None,
            "peak_mem_bytes": peak, "launches": launches, "rel_err_vs_grid_scatter_ref_f64": ref_err,
            "b4_device_ms": b4_gs[mode]["device_ms"], "b4_bound_ms": b4_gs[mode]["bound_ms"],
            "index_add_device_ms": b4_gs[mode]["library_device_ms"], "profile": profile,
            "phase_seconds": time.perf_counter() - t_phase,
        }
        emit(gs[mode])
        del captured, out, grads

    # 19. filter2d on the textured scene rendered at 2048^2: Kaiser (n_taps 6,
    # alias_guard_band 0.5, bench.py:763-764) down x2 to 1024^2 and up again,
    # then a Lanczos (n_taps 4) low-pass at freq_div 2; forward and the
    # swap-construction backward of sum(out * w) to the image. No kernel of
    # this port runs (the convolutions are cuDNN's); the op must keep float32
    # with cuDNN's TF32 at PyTorch's default, allowed, as it is here.
    t_phase = time.perf_counter()
    with torch.no_grad():
        sv2 = make_scene(2 * H, 2 * W, GN, device=dev)
        f_in, _ = render_textured(*sv2, 2 * H, 2 * W)
    del sv2
    kaiser = tt.FilterOptions(n_taps=6, filter_type=tt.FilterType.Kaiser, alias_guard_band=0.5)
    lanczos = tt.FilterOptions(n_taps=4, filter_type=tt.FilterType.Lanczos)
    f_w = torch.randn(f_in.shape, generator=gen, device=dev)

    def filter_chain(x, ops=tt, pad="reflection"):
        y1 = ops.downsample(x, kaiser, 2, pad)
        y2 = ops.upsample(y1, kaiser, 2, pad)
        return y1, y2, ops.low_pass_filter(y2, lanczos, 2.0, pad)

    def filter_step(x=f_in, ops=tt, pad="reflection"):
        x = x.detach().requires_grad_()
        return torch.autograd.grad((filter_chain(x, ops, pad)[2] * f_w.to(x.dtype)).sum(), x)[0]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        f_fwd_ms = cuda_ms(lambda: filter_chain(f_in), GS_CALLS)
        f_step_ms = cuda_ms(filter_step, GS_CALLS)
        torch.cuda.synchronize()
        f_launches = tt.kernel_launch_counts()
        if any(f_launches.values()):
            raise AssertionError(f"filter2d: launches {f_launches}, expected none")
        f_peak = peaks["filter2d"] = torch.cuda.max_memory_allocated()
        f_profile = device_profile(filter_step, PROFILED_STEPS)
        outs = filter_chain(f_in)
        refs = filter_chain(f_in.double(), filter2d_ref)
        f_fwd_err = [rel_err(o.double(), r) for o, r in zip(outs, refs)]
        # the swap-construction gradient against the op in float64; under
        # zeros padding, where it is the adjoint, against the reference's
        # autograd in float64.
        f_grad_err = rel_err(filter_step().double(), filter_step(f_in.double()))
        f_zeros_err = rel_err(filter_step(pad="zeros").double(), filter_step(f_in.double(), filter2d_ref, "zeros"))
        f_tf32_kept = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if not (max(f_fwd_err) <= 1e-5 and f_grad_err <= 1e-5 and f_zeros_err <= 1e-5 and f_tf32_kept):
        raise AssertionError(f"filter2d: forward {f_fwd_err}, gradient {f_grad_err}, zeros-padding adjoint "
                             f"{f_zeros_err} relative to float64 (limit 1e-5); TF32 setting kept: {f_tf32_kept}")
    emit({
        "phase": "filter2d", "input": list(f_in.shape), "shapes": [list(o.shape) for o in outs],
        "cudnn_allow_tf32": True, "calls_timed": GS_CALLS, "forward_ms": f_fwd_ms, "step_ms": f_step_ms,
        "device_busy_ms_per_step": f_profile["device_busy_ms_per_step"] if f_profile else None,
        "peak_mem_bytes": f_peak, "launches": f_launches, "forward_rel_err_vs_filter2d_ref_f64": f_fwd_err,
        "grad_rel_err_vs_float64": f_grad_err, "zeros_grad_rel_err_vs_ref_adjoint_f64": f_zeros_err,
        "profile": f_profile, "phase_seconds": time.perf_counter() - t_phase,
    })
    del outs, refs, f_in

    # 15. The avatar4k step (bench.py:bench_avatar4k, BASELINE config 5) at
    # full size: a 4096^2 frame of a 226x226-vertex grid (101,250
    # triangles) in 4 bands of 1024 rows, each recomputed in the backward, a
    # pyramid of 3x512^2 .. 3x64^2, an 8x4x64x128 MSI texture on 256^2
    # rays, Adam lr 1e-3 over the vertices, the levels and the MSI texture.
    t_av = time.perf_counter()
    av = scene_from_numpy(avatar4k_scene_arrays(AV_HW, AV_GN, AV_BH), dev)
    av_params = (av["v"].requires_grad_(), [x.requires_grad_() for x in av["levels"]], av["msi_tex"].requires_grad_())
    av_leaves = [av_params[0], *av_params[1], av_params[2]]
    av_opt = torch.optim.Adam(av_leaves, lr=1e-3)
    av_args = (av["vi"], av["vt"], av["ray_o"], av["ray_d"], AV_HW, AV_BANDS)
    av_faces, hb = int(av["vi"].shape[0]), AV_HW // AV_BANDS
    # per band: B1, R1 (render), B2 (interpolate K=6) and M1 (the mipmap) in
    # the forward and again in its recompute; B2 in interpolate's backward;
    # R1 in render's; E1 in edge_grad's; M1 in the mipmap's (no B3, no B4).
    av_per_step = {"B1 rasterize": 2 * AV_BANDS, "B2 gather_rows": 3 * AV_BANDS, "B3 scatter_rows": 0,
                   "B4 window_accum": 0, "B5 rasterize_lines": 0, "E1 edge_grad": AV_BANDS,
                   "M1 mipmap_sample": 3 * AV_BANDS, "R1 render": 3 * AV_BANDS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_kernel_launch_counts()
    step_marks, host_s, losses = [], [], []
    for _ in range(AV_WARMUP + AV_STEPS):
        marks = []
        t0 = time.perf_counter()
        loss, grads = avatar4k_step(av_params, av_opt, *av_args, stage_times=marks)
        host_s.append(time.perf_counter() - t0)
        step_marks.append(marks)
        losses.append(loss)
    torch.cuda.synchronize()
    av_launches = tt.kernel_launch_counts()
    n_steps = AV_WARMUP + AV_STEPS
    if av_launches != {k: c * n_steps for k, c in av_per_step.items()}:
        raise AssertionError(f"avatar4k step: launches {av_launches} over {n_steps} steps, expected {av_per_step} "
                             "per step")
    av_peak = peaks["avatar4k step"] = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    # At 4096^2 a pixel spans 1/8 of a base texel, so the mip selection
    # clamps to level 0 but where the finite differences cross the mesh's
    # silhouette; coarser levels may get no gradient at all.
    av_grads = {"v": grads["v"], "msi_tex": grads["msi_tex"],
                **{f"levels[{i}]": x for i, x in enumerate(grads["levels"])}}
    for leaf, g in av_grads.items():
        if not bool(torch.isfinite(g).all()) or (leaf in ("v", "levels[0]", "msi_tex") and not bool((g != 0).any())):
            raise AssertionError(f"avatar4k step: grad_{leaf} is not finite, or is all zero")
    av_nonzero = {leaf: int((g != 0).sum()) for leaf, g in av_grads.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"avatar4k step: losses {losses}")
    per_stage = [stage_ms(marks) for marks in step_marks[AV_WARMUP:]]
    step_ms = [sum(p.values()) for p in per_stage]
    med_ms = statistics.median(step_ms)
    av_profile = device_profile(lambda: avatar4k_step(av_params, av_opt, *av_args), AV_PROFILED)
    emit({
        "phase": "avatar4k step", "config": "avatar4k", "H": AV_HW, "W": AV_HW, "faces": av_faces, "bands": AV_BANDS,
        "levels": [list(x.shape) for x in av_params[1]], "msi_tex": list(av_params[2].shape),
        "rays": int(av["ray_o"].shape[0]), "warmup_steps": AV_WARMUP, "steps_timed": AV_STEPS,
        "step_ms_median": med_ms, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mpix_per_s": AV_HW * AV_HW / (med_ms * 1e-3) / 1e6,
        **{f"{k}_ms_median": statistics.median(p[k] for p in per_stage) for k in AVATAR4K_STAGES},
        "host_ms_per_call_median": statistics.median(host_s[AV_WARMUP:]) * 1e3,
        "device_busy_ms_per_step": av_profile["device_busy_ms_per_step"] if av_profile else None,
        "peak_mem_bytes": av_peak, "launches": av_launches, "launches_per_step": av_per_step,
        "loss_first": losses[0], "loss_last": losses[-1], "nonzero_grad_entries": av_nonzero, "profile": av_profile,
    })

    # ...its kernels held against their plain versions on the step's own
    # band-0 inputs (the current parameters): B1 under the viewport, B2 at
    # K = 9, 6 (render, interpolate) and 16 (the stencil table, band and
    # halo row), E1 on the banded edge_grad backward's band 0, B3 on that
    # band's bary x g rows; M1 on the mipmap's forward and backward, captured
    # from their launches, against the composite.
    v_av, levels_av, msi_av = av_params[0].detach(), [x.detach() for x in av_params[1]], av_params[2].detach()
    vib_av = rast.broadcast_vi(av["vi"], 1)
    b1["avatar4k_band0"] = b1_vs_plain("avatar4k band 0", v_av, av["vi"], hb, AV_HW, 0, AV_HW)
    with torch.no_grad():
        fg_av, mask_av, bary_av, idx_av = tt.map_row_bands(
            lambda y0: avatar4k_band(v_av, av["vi"], av["vt"], levels_av, y0, hb, AV_HW), AV_HW, AV_BANDS, remat=False)
        img_av = fg_av + avatar4k_background(av["ray_o"], av["ray_d"], msi_av, AV_HW) * (1.0 - mask_av)
        g_av = 2.0 * img_av / img_av.numel()  # the loss's cotangent of the shaded image
    b2_av = b2_vs_plain("avatar4k band 0", {9: _face_table(v_av, vib_av), 6: _face_table(av["vt"], vib_av)},
                        idx_av[:, :hb])
    # E1 on the banded edge_grad backward's band 0 and its halo row (one
    # launch a band, into one accumulator), and that backward alone.
    vv = v_av.clone().requires_grad_()

    def av_edge_grad_backward():
        return torch.autograd.grad(tt.edge_grad_estimator_banded(vv, av["vi"], bary_av, img_av, idx_av, AV_BANDS), vv,
                                   g_av)

    e1_bands = capture_e1(av_edge_grad_backward)
    if len(e1_bands) != AV_BANDS:
        raise AssertionError(f"avatar4k: the banded edge_grad launched E1 {len(e1_bands)} times, expected {AV_BANDS}")
    e1["avatar4k_band0"] = e1_vs_plain("avatar4k band 0 and halo", e1_bands[0])
    del e1_bands
    eg_bwd["avatar4k"] = backward_launches("avatar4k, banded", av_edge_grad_backward, AV_BANDS)
    # (B2 at K = 16 on the band's stencil rows and B3 on its bary x g rows
    # from the plain stencil: checks of B2 and B3 alone, since E1 gathers the
    # corners and reduces to vertices itself)
    blk = slice(0, hb + 1)
    idx_eg = idx_av[:, blk]
    rows_eg = edge_grad_mod._stencil_plain(_stencil_table(v_av, vib_av), idx_eg, img_av[:, :, blk], g_av[:, :, blk],
                                           bary_av[:, :, blk], 1e4, 0, AV_HW).contiguous()  # as B3's callers pass rows
    b2_av.update(b2_vs_plain("avatar4k band 0 and halo", {16: _stencil_table(v_av, vib_av)}, idx_eg))
    b3_av = b3_record("avatar4k band 0 edge_grad", rows_eg, idx_eg, av_faces)
    lv_av = [x.clone().requires_grad_() for x in levels_av]
    m1_av = m1_record("avatar4k band 0", *capture_m1(lambda: torch.autograd.grad(
        avatar4k_band(v_av, av["vi"], av["vt"], lv_av, 0, hb, AV_HW)[0], lv_av, g_av[:, :, :hb])))
    del lv_av, rows_eg

    # ...the bands against the full frame: index, bary and uv bit for bit,
    # and the banded edge_grad's gradient to v against the full frame's.
    with torch.no_grad():
        idx_full = tt.rasterize(v_av, av["vi"], AV_HW, AV_HW)
        _, bary_full = tt.render(v_av, av["vi"], idx_full)
        uv_full = tt.interpolate(av["vt"], av["vi"], idx_full, bary_full)

        def band_uv(y0):
            i = tt.rasterize(v_av, av["vi"], hb, AV_HW, y_offset=y0, full_height=AV_HW)
            _, b = tt.render(v_av, av["vi"], i, y_offset=y0)
            return i, b, tt.interpolate(av["vt"], av["vi"], i, b, y_offset=y0, full_height=AV_HW)

        idx_bands, bary_bands, uv_bands = tt.map_row_bands(band_uv, AV_HW, AV_BANDS, remat=False)
    torch.cuda.synchronize()
    if not (torch.equal(idx_bands, idx_full) and torch.equal(bary_bands, bary_full) and torch.equal(uv_bands, uv_full)
            and torch.equal(idx_av, idx_full) and torch.equal(bary_av, bary_full)):
        raise AssertionError("avatar4k: the bands' index, bary or uv differ from the full frame's")
    del bary_full, uv_full, bary_bands, uv_bands, idx_bands
    vv = v_av.clone().requires_grad_()
    (g_banded,) = torch.autograd.grad(tt.edge_grad_estimator_banded(vv, av["vi"], bary_av, fg_av, idx_av, AV_BANDS),
                                      vv, g_av)
    (g_full,) = torch.autograd.grad(tt.edge_grad_estimator(vv, av["vi"], bary_av, fg_av, idx_av), vv, g_av)
    eg_err = rel_err(g_banded, g_full)
    if not eg_err <= 1e-4:
        raise AssertionError(f"avatar4k: the banded edge_grad's gradient differs from the full frame's by {eg_err}")
    del fg_av, mask_av, bary_av, img_av, g_av, g_banded, g_full

    # ...and the step's gradients without the band recompute.
    remat = {}
    for on in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p = (v_av.clone().requires_grad_(), [x.clone().requires_grad_() for x in levels_av],
             msi_av.clone().requires_grad_())
        loss = avatar4k_loss(p, *av_args, remat=on)
        remat[on] = (loss.item(), torch.autograd.grad(loss, [p[0], *p[1], p[2]]), torch.cuda.max_memory_allocated())
    remat_err = max(rel_err(a, b) for a, b in zip(remat[True][1], remat[False][1]))
    if abs(remat[True][0] - remat[False][0]) > 1e-6 * abs(remat[False][0]) or not remat_err <= 1e-4:
        raise AssertionError(f"avatar4k: remat=True and remat=False differ (loss {remat[True][0]} vs "
                             f"{remat[False][0]}, gradients by {remat_err} of their largest magnitude)")
    emit({
        "phase": "avatar4k checks", "config": "avatar4k", "coverage": (idx_full >= 0).float().mean().item(),
        "bands_equal_full_frame": True, "edge_grad_banded_rel_err_vs_full_frame": eg_err,
        "remat_loss": remat[True][0], "no_remat_loss": remat[False][0], "remat_grad_rel_err": remat_err,
        "peak_mem_bytes_loss_and_grads": {"remat": remat[True][2], "no_remat": remat[False][2]},
        "phase_seconds": time.perf_counter() - t_av,
    })
    del remat, idx_full

    # 18. The sparse interpolation matrices on the textured frame and on the
    # inverse8 step's 8 views (one vi): A and A^T A built from the render's
    # barycentrics; per call, matvec (B2), rmatvec (B3), the normal values
    # (B3 at K = 9) and their gradient to bary (B2). matvec is held to
    # interpolate on the same x, rmatvec to interpolate's VJP, the normal
    # matrix to rmatvec(matvec(x)), and each to its plain version on the card.
    from drtk_tpu_torch.ops import interpolate as interp_mod

    im_per_call = {"B1 rasterize": 0, "B2 gather_rows": 2, "B3 scatter_rows": 2, "B4 window_accum": 0,
                   "B5 rasterize_lines": 0, "E1 edge_grad": 0, "M1 mipmap_sample": 0, "R1 render": 0}
    im_launches = {k: 0 for k in im_per_call}
    im_scenes = {"textured": (v, vi, index_img),
                 "inverse8": (inv_v_pix.detach(), inv["vi"], idx_k)}
    for scene, (sv, svi, sidx) in im_scenes.items():
        t_phase = time.perf_counter()
        n, nv = sv.shape[0], sv.shape[1]
        with torch.no_grad():
            _, sbary = tt.render(sv, svi, sidx)
        x = torch.randn((n, nv, 3), generator=gen, device=dev)
        y = torch.randn((n, sidx.shape[1] * sidx.shape[2], 3), generator=gen, device=dev)
        wv_gen = torch.Generator(device=dev).manual_seed(1)
        interp_mod._STRUCTURE_CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        structure = tt.interpolation_normal_structure(svi, nv)
        structure_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        hit = tt.interpolation_normal_structure(svi, nv)
        hit_ms = (time.perf_counter() - t0) * 1e3
        if hit is not structure:
            raise AssertionError(f"interpolation matrices {scene}: the structure cache missed")
        wv = torch.randn((n, int(structure.rows.shape[0])), generator=wv_gen, device=dev)

        def products(impl="auto", sbary=sbary):
            b = sbary.clone().requires_grad_()
            a = tt.interpolation_matrix(svi, sidx, b, nv, impl=impl)
            nm = tt.interpolation_normal_matrix(svi, sidx, b, nv, impl=impl)
            (g_bary,) = torch.autograd.grad((nm.vals * wv).sum(), b)
            return a, nm, a.matvec(x), a.rmatvec(y), g_bary

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        a, nm, ax, aty, g_bary = products()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = tt.kernel_launch_counts()
        peaks[f"interpolation matrices {scene}"] = torch.cuda.max_memory_allocated()
        if launches != im_per_call:
            raise AssertionError(f"interpolation matrices {scene}: launches {launches}, expected {im_per_call}")
        im_launches = {k: im_launches[k] + c for k, c in launches.items()}
        fg = (sidx >= 0)[:, None]
        with torch.no_grad():
            img = tt.interpolate(x, svi, sidx, sbary)
        want_ax = torch.where(fg, img, 0.0).movedim(1, -1).reshape(ax.shape)
        xl = x.clone().requires_grad_()
        (want_aty,) = torch.autograd.grad(tt.interpolate(xl, svi, sidx, sbary), xl,
                                          y.reshape(n, sidx.shape[1], sidx.shape[2], 3).movedim(-1, 1))
        plain = products("plain")
        errs = {
            "matvec_vs_interpolate": rel_err(ax, want_ax), "rmatvec_vs_interpolate_vjp": rel_err(aty, want_aty),
            "normal_matvec_vs_rmatvec_matvec": rel_err(nm.matvec(x), a.rmatvec(a.matvec(x))),
            "matvec_vs_plain": rel_err(ax, plain[2]), "rmatvec_vs_plain": rel_err(aty, plain[3]),
            "normal_values_vs_plain": rel_err(nm.vals, plain[1].vals),
            "normal_values_grad_vs_plain": rel_err(g_bary, plain[4]),
        }
        limits = {k: 1e-6 if k.startswith("matvec") else 1e-5 for k in errs}
        if not all(errs[k] <= limits[k] for k in errs) or not torch.equal(a.cols, plain[0].cols):
            raise AssertionError(f"interpolation matrices {scene}: errors {errs} over their limits {limits}")
        b_leaf = sbary.clone().requires_grad_()

        def values_and_grad():
            vals = tt.interpolation_normal_matrix_values(structure, svi, sidx, b_leaf)
            return torch.autograd.grad((vals * wv).sum(), b_leaf)

        def plain_values():
            return tt.interpolation_normal_matrix_values(structure, svi, sidx, sbary, impl="plain")

        times = {
            "matvec_ms": cuda_ms(lambda: a.matvec(x), 20), "matvec_plain_ms": cuda_ms(lambda: plain[0].matvec(x), 5),
            "rmatvec_ms": cuda_ms(lambda: a.rmatvec(y), 20),
            "rmatvec_plain_ms": cuda_ms(lambda: plain[0].rmatvec(y), 5),
            "normal_values_ms": cuda_ms(lambda: tt.interpolation_normal_matrix_values(structure, svi, sidx, sbary),
                                        20),
            "normal_values_plain_ms": cuda_ms(plain_values, 5),
            "normal_values_and_grad_ms": cuda_ms(values_and_grad, 20),
            "build_matrix_ms": cuda_ms(lambda: tt.interpolation_matrix(svi, sidx, sbary, nv), 20),
        }
        profile = device_profile(lambda: (a.matvec(x), a.rmatvec(y), values_and_grad()), PROFILED_STEPS)
        emit({
            "phase": "interpolation matrices", "scene": scene, "batch": n, "H": int(sidx.shape[1]),
            "W": int(sidx.shape[2]), "faces": int(svi.shape[-2]), "vertices": nv,
            "foreground_pixels": int(fg.sum()), "nnz": int(structure.rows.shape[0]),
            "structure_host_ms": structure_ms, "structure_cache_hit_ms": hit_ms, "first_products_ms": first_ms,
            **times, "device_busy_ms_per_call": profile["device_busy_ms_per_step"] if profile else None,
            "launches": launches, "rel_errs": errs, "limits": limits, "profile": profile,
            "peak_mem_bytes": peaks[f"interpolation matrices {scene}"],
            "phase_seconds": time.perf_counter() - t_phase,
        })
        if scene == "textured":
            bary_rows = sbary.movedim(1, -1)
            b3["normal_values"] = b3_record(
                "textured normal values", (bary_rows[..., :, None] * bary_rows[..., None, :]).reshape(
                    n, sidx.shape[1], sidx.shape[2], 9), sidx, int(svi.shape[-2]))
        del a, nm, ax, aty, g_bary, plain, want_ax, want_aty, img

    # 19. The row-sharded step.
    sharded_rank0 = row_sharded_phase()
    sharded_launches = sharded_rank0["launches"]
    e1["row-sharded rank 0"] = {"verts max_dp_dr=10000": sharded_rank0["e1_vs_plain"]}
    peaks["row-sharded step rank 0"] = sharded_rank0["peak_mem_bytes"]

    # 14. The kernels, with the numbers of this run; times per fitting step
    # (B2: K=6 in interpolate's forward and backward; B3: K=6 in
    # interpolate's backward; E1 once, the whole edge_grad backward, in verts
    # mode; R1 once each way, render's). B2's K=9 and K=16 launches and B3's
    # K=9 ones and on edge_grad's rows are checks of B2 and B3 alone: since
    # E1 and R1, no step makes them.
    b2_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")

    def b2_step(key, recs=b2):
        return 2 * recs[6][key]

    def b3_step(key):
        return b3[6][key]

    by_path = {"fit_step": main_launches, "inverse8_step": inv_launches, "wireframe": wire_launches,
               "avatar4k": av_launches, "fisheye62_step": fish["launches"], "lens_list_step": mixed["launches"],
               "mipmap_views": mv_launches, **{f"grid_scatter_{m}": c for m, c in gs_launches.items()},
               "filter2d": f_launches, "interpolation_matrices": im_launches,
               "row_sharded_step_rank0": sharded_launches}

    def paths(key):
        return {path: counts[key] for path, counts in by_path.items()}

    kernels = [
        {"name": "B1 rasterize_pallas._tile_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/rasterize.cu", "replaces": "drtk_tpu/ops/rasterize_pallas.py:257",
         "launches": main_launches["B1 rasterize"], "launches_per_step": 1,
         "max_abs_err": b1["textured"]["max_abs_depth_err"],
         "ms": b1["textured"]["ms"], "device_ms": b1["textured"]["device_ms"],
         "plain_ms": b1["textured"]["plain_ms"], "bound_ms": b1["textured"]["bound_ms"],
         "bound_by": b1["textured"]["bound_by"], "library_ms": None,
         "by_scene": {sc: {k: r[k] for k in ("ms", "ms_runs", "device_ms", "plain_ms", "bound_ms", "bit_exact",
                                             "pairs", "big_list", "bins_bytes")} for sc, r in b1.items()}},
        {"name": "B2 segment_rows._gather_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/gather_rows.cu", "replaces": "drtk_tpu/ops/segment_rows.py:359",
         "launches": main_launches["B2 gather_rows"], "launches_per_step": 2, "max_abs_err": 0.0,
         "ms": b2_step("ms"), "device_ms": b2_step("device_ms"), "plain_ms": b2_step("plain_ms"),
         "bound_ms": b2_step("bound_ms"), "bound_by": "bytes", "library_ms": b2_step("library_ms"),
         "library_device_ms": b2_step("library_device_ms"),
         "inverse8_step": {k: b2_step(k, b2_inv) for k in b2_keys},
         "per_launch": {image: {k_dim: {k: r[k] for k in b2_keys if k != "plain_ms"} for k_dim, r in recs.items()}
                        for image, recs in (("textured", b2), ("inverse8", b2_inv), ("avatar4k_band0", b2_av),
                                            ("mipmap_views_uv_derivative", b2_mv))}},
        {"name": "B3 segment_rows._accumulate_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/scatter_rows.cu", "replaces": "drtk_tpu/ops/segment_rows.py:129",
         "launches": main_launches["B3 scatter_rows"], "launches_per_step": 1,
         "max_abs_err": max(r["max_abs_err"] for recs in (b3, b3_inv, {9: b3_av}) for r in recs.values()),
         "ms": b3_step("ms"), "device_ms": b3_step("device_ms"), "plain_ms": b3_step("plain_ms"),
         "bound_ms": b3_step("bound_ms"), "bound_by": "bytes", "library_ms": b3_step("library_ms"),
         "library_device_ms": b3_step("library_device_ms"),
         "per_launch": {image: {k_dim: {k: r[k] for k in b3_keys} for k_dim, r in recs.items()}
                        for image, recs in (("textured", b3), ("inverse8", b3_inv),
                                            ("avatar4k_edge_grad_band0", {9: b3_av}))}},
        {"name": "B4 window_accum._window_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/window_accum.cu", "replaces": "drtk_tpu/ops/window_accum.py:92",
         "launches": main_launches["B4 window_accum"], "launches_per_step": 1,
         "max_abs_err": max(r["max_abs_err"] for r in (b4, b4_inv, *b4_gs.values())),
         "ms": b4["ms"], "device_ms": b4["device_ms"], "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"],
         "bound_by": "bytes", "library_ms": b4["library_ms"], "library_device_ms": b4["library_device_ms"],
         "inverse8_step": {k: b4_inv[k] for k in b3_keys},
         "grid_scatter": {mode: {k: r[k] for k in b3_keys + ("max_abs_err", "taps", "live_taps", "rows_hw")}
                          for mode, r in b4_gs.items()}},
        {"name": "B5 rasterize_pallas._lines_tile_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/rasterize_lines.cu", "replaces": "drtk_tpu/ops/rasterize_pallas.py:715",
         "launches": wire_launches["B5 rasterize_lines"], "launches_per_step": 1,
         "max_abs_err": b5["inverse8"]["max_abs_depth_err"], "ms": b5["inverse8"]["ms"],
         "device_ms": b5["inverse8"]["device_ms"], "plain_ms": b5["inverse8"]["plain_ms"], "bound_ms": b5["inverse8"]["bound_ms"],
         "bound_by": b5["inverse8"]["bound_by"], "full_test_ops_ms": b5["inverse8"]["full_test_ops_ms"],
         "key_buffer_ms": b5["inverse8"]["key_buffer_ms"], "library_ms": None},
        {"name": "E1 edge_grad backward", "route": "cuda", "source": "drtk_tpu_torch/csrc/edge_grad.cu",
         "replaces": "drtk_tpu/ops/edge_grad.py:114 _edge_grad_backward and :288-318 _edge_grad_core_bwd (B2's K=16 "
                     "gather + XLA stencil + B3's accumulate + the vertex scatter)",
         "launches": main_launches["E1 edge_grad"], "launches_per_step": 1,
         **{k: e1["textured"]["verts max_dp_dr=10000"][k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                                                     "bound_ms", "bound_by", "library_ms")},
         "kernel_device_ms": e1["textured"]["verts max_dp_dr=10000"]["kernel_device_ms"],
         "by_input": {label: {mode: {k: r[k] for k in ("ms", "device_ms", "kernel_device_ms", "plain_ms", "bound_ms",
                                                       "rel_err", "nonzero_equal") if k in r}
                              for mode, r in recs.items()} for label, recs in e1.items()}},
        {"name": "M1 mipmap_grid_sample (bilinear)", "route": "cuda", "source": "drtk_tpu_torch/csrc/mipmap_sample.cu",
         "replaces": "drtk_tpu/ops/mipmap_grid_sample.py:441-585 _mipmap_grid_sample_impl and :218-283 the "
                     "window-accumulate backward (atlas, quad table, tap rows, B4)",
         "launches": av_launches["M1 mipmap_sample"], "launches_per_step": 3 * AV_BANDS,
         **{k: m1_av[k] for k in ("ms", "device_ms", "bwd_ms", "bwd_device_ms", "plain_ms", "bound_ms",
                                  "bwd_bound_ms", "rel_err", "window_adds", "fallback_adds")},
         "bound_by": "bytes", "library_ms": None, "mipmap_views": m1_mv},
        {"name": "R1 render", "route": "cuda", "source": "drtk_tpu_torch/csrc/render.cu",
         "replaces": "drtk_tpu/ops/render.py:69 _render_fwd_math and :118 _render_core_bwd (B2's K=9 gather + XLA, "
                     "B3's accumulate + the vertex scatter)",
         "launches": main_launches["R1 render"], "launches_per_step": 2, "bound_by": "bytes", "library_ms": None,
         "by_input": r1},
    ]
    for row, key in zip(kernels, ("B1 rasterize", "B2 gather_rows", "B3 scatter_rows", "B4 window_accum",
                                  "B5 rasterize_lines", "E1 edge_grad", "M1 mipmap_sample", "R1 render")):
        row["launches_by_path"] = paths(key)
    emit({"phase": "peak memory by path", "peak_mem_bytes": peaks,
          "edge_grad_backward_alone": {path: r["peak_mem_bytes"] for path, r in eg_bwd.items()}})
    emit({"kernels": kernels})
    return finish(smi)


def finish(smi: str) -> int:
    """The last two lines: the card's name and power limit, and the result."""
    if "jax" in sys.modules or "drtk_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
