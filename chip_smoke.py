"""Drive drtk_tpu_torch's render paths and fitting steps on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels from the sources in this checkout, holds each
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
  Adam update).

The face-row gather (B2), the pixel-to-face accumulation (B3) and the
texture-gradient scatter (B4) are held against their plain versions on the
index images (B4: the taps) of the textured scene and of the inverse8
step's 8 views, B3 and B4 with the global atomics their designs imply
(modeled from the index image or the taps, not counted on the card); triangle
rasterization (B1), bit for bit, on the entry and textured scenes and on
the views of the inverse8 step; wireframe rasterization (B5) on the entry,
textured and inverse8 scenes; and row-tile viewports of B1 and B5 against
the full frame. Times come from CUDA events: a kernel's ``ms`` (and
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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# TF32 off for matrix products and cuDNN: nothing on this path should use
# either, and with both off a stray library call cannot silently round f32
# operands to 10 mantissa bits in the comparisons below.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 1024  # the textured configuration (bench.py: bench_textured)
GN = 161  # 161x161 vertices -> 51,200 triangles
ENTRY_HW = 256  # the entry() scene: 96 random vertices, 128 large triangles
WARMUP, STEPS = 3, 25
PROFILED_STEPS = 5
FLOPS_PER_TEST = 17  # per pixel centre tested by B1: 3 edges x (2 mul + 2 add), di 3 mul + 2 add
INV_HW, INV_GN, INV_VIEWS = 512, 81, 8  # the inverse8 configuration (bench.py: bench_inverse8)
# Per pixel tested by B5: 3 edges x 4, then clip, renormalise and di (3 mul, 3 x 2 clamp, 2 add, 3 div,
# 3 mul, 2 add); per visible edge its line (2 sub, 2 mul, 1 sub) and four diamond sides of 16 (a2, b2:
# 2 sub; c2, d: 2 x (2 mul + 1 sub); cx, cy: 2 x (2 mul + 1 sub + 1 div)), each division counted once.
LINE_FLOPS_PER_TEST, LINE_FLOPS_PER_EDGE = 12 + 19, 5 + 4 * 16
CAMS = ("campos", "camrot", "focal", "princpt")


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
    operation ran, and the costliest operations (ms per step). None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    return {
        "steps": n_steps, "device_ops_per_step": len(spans) / n_steps,
        "device_busy_ms_per_step": busy / n_steps / 1e3, "device_window_ms_per_step": window / n_steps / 1e3,
        "device_busy_share": busy / window if window > 0 else None,
        "top_device_ops_ms_per_step": {name: us / n_steps / 1e3 for name, us in top},
    }


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 2
    try:
        import drtk_tpu_torch as tt
        from drtk_tpu_torch import _build
        from drtk_tpu_torch.ops import rasterize as rast
        from drtk_tpu_torch.ops import grid_sample as gs
        from drtk_tpu_torch.ops import rasterize_cuda, segment_rows, window_accum
        from drtk_tpu_torch.ops.render import _face_table
        from drtk_tpu_torch.interop import scene_from_numpy
        from drtk_tpu_torch.pipeline import (
            BACKWARD_STAGES, FIT_STAGES, INVERSE8_STAGES, STAGES, fit_step, inverse8_step, render_multiview,
            render_textured, stage_ms,
        )
        from drtk_tpu_torch.scenes import entry_scene, inverse8_scene_arrays, make_scene, with_edge_flags
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
        **tables, 16: torch.from_numpy(rng.randn(1, n_faces, 16).astype(np.float32)).to(dev),  # edge_grad's width
    }, index_img)

    # 4. B1 vs plain on the entry scene and the textured scene (and, in
    # phase 13, on the inverse8 step's views)
    def b1_vs_plain(scene, sv, svi, hh, ww) -> dict:
        svib = rast.broadcast_vi(svi, sv.shape[0])
        setup = rast.triangle_setup(sv, svib)
        valid = rast._canvas_cull(setup, hh, ww)
        coef, meta = rasterize_cuda.pack_setup(setup, valid, hh, ww)
        d, i, bins = rasterize_cuda._resolve_binned(coef, meta, hh, ww)
        d_ref, i_ref = rast._rasterize_plain(setup, valid, hh, ww)
        torch.cuda.synchronize()
        rec = check_raster(f"B1 {scene}", d_ref, i_ref, d, i)
        if not (torch.equal(d, d_ref) and torch.equal(i, i_ref)):
            raise AssertionError(f"B1 {scene}: kernel not bit-identical to the plain resolve")
        m = meta.long()
        tests = ((m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)).sum().item()
        nbytes = coef.numel() * 4 + meta.numel() * 4 + d.numel() * 4 + i.numel() * 4
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = tests * FLOPS_PER_TEST / f32_flops * 1e3
        ms_runs = [cuda_ms(lambda: rasterize_cuda.resolve_packed(coef, meta, hh, ww), 20) for _ in range(3)]
        rec.update({
            "H": hh, "W": ww, "batch": int(sv.shape[0]), "faces": int(svib.shape[1]), "bit_exact": True,
            "pairs": int(bins.starts[-1]), "pair_capacity": bins.pairs.numel(),
            "big_list": int(bins.big_count.sum()),
            "bins_bytes": 4 * sum(rasterize_cuda._bin_sizes(*coef.shape[:2], hh, ww)),
            "ms": statistics.median(ms_runs), "ms_runs": ms_runs,
            "device_ms": graph_ms(lambda: rasterize_cuda.resolve_packed(coef, meta, hh, ww)),
            "plain_ms": cuda_ms(lambda: rast._rasterize_plain(setup, valid, hh, ww), 2, warmup=1),
            "rasterize_call_ms": cuda_ms(lambda: tt.rasterize_with_depth(sv, svi, hh, ww), 20),
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
    if launches != {"B1 rasterize": n_steps, "B2 gather_rows": 2 * n_steps, "B3 scatter_rows": 0,
                    "B4 window_accum": 0, "B5 rasterize_lines": 0}:
        raise AssertionError(f"main path launches {launches} over {n_steps} steps, expected 1 B1 and 2 B2 per step")
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

    # 6. B3 vs plain: rows from a seeded generator on the textured scene's
    # index image (and, after phase 13, on the inverse8 step's), with the
    # global atomics of the kernel's design, modeled, against a per-pixel
    # scatter's.
    gen = torch.Generator(device=dev).manual_seed(0)
    b3_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")

    def b3_vs_plain(image, idx, f_cnt) -> dict:
        n = idx.shape[0]
        fg = idx >= 0
        n_fg = int(fg.sum())
        lib_idx = (idx.long().clamp(max=f_cnt - 1) + torch.arange(n, device=dev)[:, None, None] * f_cnt)[fg]
        recs = {}
        for k_dim in (9, 6):
            rows = torch.randn((*idx.shape, k_dim), generator=gen, device=dev)
            got = segment_rows.scatter_rows_to_faces(rows, idx, f_cnt)
            want = segment_rows._scatter_rows_plain(rows, idx, f_cnt)
            magnitude = segment_rows._scatter_rows_plain(rows.abs(), idx, f_cnt)
            lib_rows = rows[fg]

            def library(lib_rows=lib_rows, k_dim=k_dim):
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
            recs[k_dim] = {
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
            emit({"phase": "B3 vs plain", "image": image, "batch": n, "faces": f_cnt, "K": k_dim, **recs[k_dim]})
        return recs

    b3 = b3_vs_plain("textured", index_img, n_faces)

    # 7. B4 vs plain on the taps of a step's own grid_sample: the quad-row
    # index of every pixel's bilinear border sample of the texture, the taps
    # in their H x W shape, as grid_sample passes them (textured here, the
    # inverse8 step's after phase 13), with the global atomics of the
    # kernel's design, modeled, against a per-tap scatter's.

    def b4_vs_plain(image, sv, svi, svt, stex, idx) -> dict:
        n, hh, ww = idx.shape
        t_h, t_w = stex.shape[2:]
        fg = idx >= 0
        n_fg = int(fg.sum())
        with torch.no_grad():
            _, bary0 = tt.render(sv, svi, idx)
            uv = tt.interpolate(svt, svi, idx, bary0).movedim(1, -1) * 2.0 - 1.0
        bx = torch.floor(gs._compute_source_index(uv[..., 0], t_w, "border", False)).int().clamp(0, t_w - 1)
        by = torch.floor(gs._compute_source_index(uv[..., 1], t_h, "border", False)).int().clamp(0, t_h - 1)
        k4 = 4 * stex.shape[1]  # the quad table's rows
        cot = torch.randn((n, hh * ww, k4), generator=gen, device=dev) * fg.reshape(n, -1, 1)  # zero at background
        iy = torch.where(fg, by, -1).reshape(n, -1)
        ix = bx.reshape(n, -1)
        rows_kp = cot.transpose(1, 2)  # the [N, K, P] view the row scatter passes
        args = (rows_kp, iy, ix, t_h, t_w, (hh, ww))
        got = window_accum._window_accumulate_cuda(*args)
        want = window_accum._window_accumulate_plain(*args[:5])
        magnitude = window_accum._window_accumulate_plain(rows_kp.abs(), *args[1:5])
        lib_flat = ((by * t_w + bx) + torch.arange(n, device=dev)[:, None, None] * (t_h * t_w))[fg].long()
        lib_rows = cot[fg.reshape(n, -1)].t().contiguous()

        def library_b4():
            return torch.zeros((k4, n * t_h * t_w), device=dev).index_add_(1, lib_flat, lib_rows)

        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B4 {image}: kernel differs from the plain scatter by {err.max().item()}")
        lib = library_b4().reshape(k4, n, t_h, t_w).movedim(0, 1)
        if not bool(((lib - want).abs() <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B4 {image}: the library yardstick computes another function")
        nbytes = n_fg * k4 * 4 + iy.numel() * 4 + ix.numel() * 4 + n * k4 * t_h * t_w * 4
        atomics = modeled_window_atomics(iy, ix, t_h, t_w, k4, (hh, ww))
        rec = {
            "K": k4, "batch": n, "taps": iy.numel(), "live_taps": n_fg, "rows_hw": [hh, ww], "table": [t_h, t_w],
            "ms": cuda_ms(lambda: window_accum._window_accumulate_cuda(*args), 50),
            "device_ms": graph_ms(lambda: window_accum._window_accumulate_cuda(*args)),
            "plain_ms": cuda_ms(lambda: window_accum._window_accumulate_plain(*args[:5]), 20),
            "library_ms": cuda_ms(library_b4, 50), "library_device_ms": graph_ms(library_b4),
            "library": "index_add_ of the live taps' rows (the plain "
            "version's core, without its masking)",
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": err.max().item(),
            "modeled_global_atomics": atomics, "modeled_per_tap_atomics": n_fg * k4,
            "modeled_atomics_fall": n_fg * k4 / max(atomics, 1),
        }
        emit({"phase": "B4 vs plain", "image": image, **rec})
        return rec

    b4 = b4_vs_plain("textured", v, vi, vt, tex, index_img)

    # 8. The main path of this slice: the fitting step at full size, with
    # gradients to v, vt and tex, then bench_textured's v-only gradient.
    expected = {
        ("v", "vt", "tex"): {"B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 3, "B4 window_accum": 1,
                             "B5 rasterize_lines": 0},
        ("v",): {"B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 2, "B4 window_accum": 0,
                 "B5 rasterize_lines": 0},
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

    # 10. B5 vs plain, every edge visible: the entry scene (canvas-sized
    # triangles), the textured scene, and the inverse8 views through transform.
    inv = scene_from_numpy(inverse8_scene_arrays(INV_HW, INV_GN, INV_VIEWS), dev)
    cams = {k: inv[k] for k in CAMS}
    inv_vi_wire = torch.from_numpy(with_edge_flags(inv["vi"].cpu().numpy())).to(dev)
    with torch.no_grad():
        inv_v_pix = tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams)
    vi_wire = torch.from_numpy(with_edge_flags(vi.cpu().numpy())).to(dev)
    b5 = {}
    for scene, (sv, svi, hh, ww) in {
        "entry": (entry[0], torch.from_numpy(with_edge_flags(entry[1].cpu().numpy())).to(dev), ENTRY_HW, ENTRY_HW),
        "textured": (v, vi_wire, H, W),
        "inverse8": (inv_v_pix, inv_vi_wire, INV_HW, INV_HW),
    }.items():
        svib = rast.broadcast_vi(svi, sv.shape[0])
        setup, lines = rast.triangle_setup(sv, svib), rast.line_setup(sv, svib)
        valid = rast._canvas_cull(setup, hh, ww)
        rows, meta, ends = rasterize_cuda.pack_lines(setup, lines, valid, hh, ww, 0, hh)
        d, i = rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww)
        d_ref, i_ref = rast._rasterize_lines_plain(setup, lines, valid, hh, ww, 0, hh)
        torch.cuda.synchronize()
        rec = check_raster(f"B5 {scene}", d_ref, i_ref, d, i)
        if not bool((i >= 0).any()):
            raise AssertionError(f"B5 {scene}: no pixel indexed")
        m = meta.long()
        area = (m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)
        n_vis = ((m[..., 0] >> 3) & 1) + ((m[..., 0] >> 4) & 1) + ((m[..., 0] >> 5) & 1)
        tests = int(ends[-1])
        flops = int((area * (LINE_FLOPS_PER_TEST + LINE_FLOPS_PER_EDGE * n_vis)).sum())
        nbytes = rows.numel() * 4 + meta.numel() * 4 + ends.numel() * 8 + d.numel() * (8 + 4 + 4)
        bound_bytes_ms, bound_ops_ms = nbytes / bw * 1e3, flops / f32_flops * 1e3
        ms_runs = [cuda_ms(lambda: rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww), 20)
                   for _ in range(3)]
        rec.update({
            "H": hh, "W": ww, "batch": int(sv.shape[0]), "faces": int(svib.shape[1]),
            "bit_exact": bool(torch.equal(d, d_ref) and torch.equal(i, i_ref)),
            "indexed_pixels": int((i >= 0).sum()), "depth_only_pixels": int(((i < 0) & (d > 0)).sum()),
            "ms": statistics.median(ms_runs), "ms_runs": ms_runs,
            "device_ms": graph_ms(lambda: rasterize_cuda.resolve_lines_packed(rows, meta, ends, hh, ww)),
            "plain_ms": cuda_ms(lambda: rast._rasterize_lines_plain(setup, lines, valid, hh, ww, 0, hh), 2, warmup=1),
            "rasterize_call_ms": cuda_ms(lambda: tt.rasterize_with_depth(sv, svi, hh, ww, wireframe=True), 20),
            "pixel_tests": tests, "flops": flops, "bytes": nbytes,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations", "library_ms": None,
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
    tt.reset_kernel_launch_counts()
    with torch.no_grad():
        wire_idx = tt.rasterize(tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams), inv_vi_wire,
                                INV_HW, INV_HW, wireframe=True)
    torch.cuda.synchronize()
    wire_launches = tt.kernel_launch_counts()
    if wire_launches != {**{k: 0 for k in wire_launches}, "B5 rasterize_lines": 1}:
        raise AssertionError(f"wireframe path: launches {wire_launches}, expected B5 once")
    if wire_idx.shape != (INV_VIEWS, INV_HW, INV_HW) or not bool((wire_idx >= 0).flatten(1).any(1).all()):
        raise AssertionError("wireframe path: a view with no indexed pixel, or the wrong shape")
    with torch.no_grad():
        wire_ms = cuda_ms(lambda: tt.rasterize(tt.transform(inv["v_world"].expand(INV_VIEWS, -1, -1), **cams),
                                               inv_vi_wire, INV_HW, INV_HW, wireframe=True), 20)
    emit({"phase": "wireframe path", "config": "inverse8", "views": INV_VIEWS, "H": INV_HW, "W": INV_HW,
          "launches": wire_launches, "ms": wire_ms, "indexed_share": (wire_idx >= 0).float().mean().item()})

    # 13. The main path of this slice: the inverse8 training step at full
    # size (8 views of 512^2, 12,800 triangles, a 3x256x256 texture, Adam
    # lr 1e-3), from bench.py's start: the vertices moved by 0.02 and a grey
    # texture, against the image rendered once from the true ones.
    with torch.no_grad():
        img_gt, _ = render_multiview(inv["v_world"], inv["vi"], inv["vt"], inv["tex_gt"], cams, INV_HW, INV_HW)
    inv_params = ((inv["v_world"] + 0.02).requires_grad_(), torch.full_like(inv["tex_gt"], 0.5).requires_grad_())
    inv_opt = torch.optim.Adam(inv_params, lr=1e-3)
    inv_args = (inv["vi"], inv["vt"], cams, img_gt, INV_HW, INV_HW)
    inv_per_step = {"B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 2, "B4 window_accum": 1,
                    "B5 rasterize_lines": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_kernel_launch_counts()
    step_marks, host_s, losses = [], [], []
    for _ in range(WARMUP + STEPS):
        marks = []
        t0 = time.perf_counter()
        loss, grads = inverse8_step(inv_params, inv_opt, *inv_args, stage_times=marks)
        host_s.append(time.perf_counter() - t0)
        step_marks.append(marks)
        losses.append(loss)
    torch.cuda.synchronize()
    inv_launches = tt.kernel_launch_counts()
    n_steps = WARMUP + STEPS
    if inv_launches != {k: c * n_steps for k, c in inv_per_step.items()}:
        raise AssertionError(f"inverse8 step: launches {inv_launches} over {n_steps} steps, expected {inv_per_step} "
                             "per step")
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"inverse8 step: the loss went from {losses[0]} to {losses[-1]}")
    for leaf, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"inverse8 step: grad_{leaf} is not finite")
    per_stage = [stage_ms(marks) for marks in step_marks[WARMUP:]]
    step_ms = [sum(p.values()) for p in per_stage]
    med_ms = statistics.median(step_ms)
    fwd_stages = INVERSE8_STAGES[: INVERSE8_STAGES.index("loss") + 1]
    profile = device_profile(lambda: inverse8_step(inv_params, inv_opt, *inv_args), PROFILED_STEPS)

    # ...its B1 launch held against the plain rasterizer on the same views
    # (8 x 512^2, 12,800 triangles each), then the step held against the
    # plain pipeline on the kernel's index image, each side from a copy of
    # the current parameters with an optimizer of its own.
    with torch.no_grad():
        inv_v_pix = tt.transform(inv_params[0].expand(INV_VIEWS, -1, -1), **cams)
    b1["inverse8"] = b1_vs_plain("inverse8", inv_v_pix, inv["vi"], INV_HW, INV_HW)
    idx_k = tt.rasterize(inv_v_pix, inv["vi"], INV_HW, INV_HW)
    side = {}
    for impl in ("auto", "plain"):
        p = tuple(t.detach().clone().requires_grad_() for t in inv_params)
        side[impl] = inverse8_step(p, torch.optim.Adam(p, lr=1e-3), *inv_args, index_img=idx_k, impl=impl)
    (loss_k, grads_k), (loss_p, grads_p) = side["auto"], side["plain"]
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if loss_err > 1e-5:
        raise AssertionError(f"inverse8 step: loss differs from the plain pipeline's by {loss_err} relative")
    inv_grad_err = {}
    for leaf in ("v_world", "tex"):
        inv_grad_err[leaf] = (grads_k[leaf] - grads_p[leaf]).abs().max().item() / grads_p[leaf].abs().max().item()
        if not inv_grad_err[leaf] <= 1e-4:
            raise AssertionError(f"inverse8 step: grad_{leaf} differs from the plain pipeline's by "
                                 f"{inv_grad_err[leaf]} of its largest magnitude")
    emit({
        "phase": "inverse8 step", "config": "inverse8", "views": INV_VIEWS, "H": INV_HW, "W": INV_HW,
        "faces": int(inv["vi"].shape[0]), "steps_timed": STEPS, "step_ms_median": med_ms,
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mpix_per_s": INV_VIEWS * INV_HW * INV_HW / (med_ms * 1e-3) / 1e6,
        "forward_ms_median": statistics.median(sum(p[k] for k in fwd_stages) for p in per_stage),
        "backward_ms_median": statistics.median(
            sum(p[k] for k in BACKWARD_STAGES + ("transform_bwd",)) for p in per_stage),
        "host_ms_per_call_median": statistics.median(host_s[WARMUP:]) * 1e3,
        "stage_ms_median": {k: statistics.median(p[k] for p in per_stage) for k in INVERSE8_STAGES},
        "peak_mem_bytes": peak, "launches": inv_launches, "launches_per_step": inv_per_step,
        "loss_first": losses[0], "loss_last": losses[-1], "coverage": (idx_k >= 0).float().mean().item(),
        "loss_rel_err_vs_plain": loss_err, "grad_rel_err_vs_plain": inv_grad_err, "profile": profile,
    })

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

    # 14. The kernels, with the numbers of this run; times per fitting step
    # (B2: K=9 and K=6 in the forward, again in the backward, and K=16 in
    # edge_grad's backward; B3: K=9 in render's and edge_grad's backward,
    # K=6 in interpolate's).
    b2_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")

    def b2_step(key, recs=b2):
        return 2 * recs[9][key] + 2 * recs[6][key] + recs[16][key]

    def b3_step(key):
        return 2 * b3[9][key] + b3[6][key]

    def b3_inv_step(key):  # B3 at K=9 in render's and edge_grad's backward
        return 2 * b3_inv[9][key]

    by_path = {"fit_step": main_launches, "inverse8_step": inv_launches, "wireframe": wire_launches}

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
         "launches": main_launches["B2 gather_rows"], "launches_per_step": 5, "max_abs_err": 0.0,
         "ms": b2_step("ms"), "device_ms": b2_step("device_ms"), "plain_ms": b2_step("plain_ms"),
         "bound_ms": b2_step("bound_ms"), "bound_by": "bytes", "library_ms": b2_step("library_ms"),
         "library_device_ms": b2_step("library_device_ms"),
         "inverse8_step": {k: b2_step(k, b2_inv) for k in b2_keys},
         "per_launch": {image: {k_dim: {k: r[k] for k in b2_keys if k != "plain_ms"} for k_dim, r in recs.items()}
                        for image, recs in (("textured", b2), ("inverse8", b2_inv))}},
        {"name": "B3 segment_rows._accumulate_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/scatter_rows.cu", "replaces": "drtk_tpu/ops/segment_rows.py:129",
         "launches": main_launches["B3 scatter_rows"], "launches_per_step": 3,
         "max_abs_err": max(r["max_abs_err"] for recs in (b3, b3_inv) for r in recs.values()),
         "ms": b3_step("ms"), "device_ms": b3_step("device_ms"), "plain_ms": b3_step("plain_ms"),
         "bound_ms": b3_step("bound_ms"), "bound_by": "bytes", "library_ms": b3_step("library_ms"),
         "library_device_ms": b3_step("library_device_ms"),
         "inverse8_step": {k: b3_inv_step(k) for k in b3_keys},
         "per_launch": {image: {k_dim: {k: r[k] for k in b3_keys} for k_dim, r in recs.items()}
                        for image, recs in (("textured", b3), ("inverse8", b3_inv))}},
        {"name": "B4 window_accum._window_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/window_accum.cu", "replaces": "drtk_tpu/ops/window_accum.py:92",
         "launches": main_launches["B4 window_accum"], "launches_per_step": 1,
         "max_abs_err": max(b4["max_abs_err"], b4_inv["max_abs_err"]),
         "ms": b4["ms"], "device_ms": b4["device_ms"], "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"],
         "bound_by": "bytes", "library_ms": b4["library_ms"], "library_device_ms": b4["library_device_ms"],
         "inverse8_step": {k: b4_inv[k] for k in b3_keys}},
        {"name": "B5 rasterize_pallas._lines_tile_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/rasterize_lines.cu", "replaces": "drtk_tpu/ops/rasterize_pallas.py:715",
         "launches": wire_launches["B5 rasterize_lines"], "launches_per_step": 1,
         "max_abs_err": b5["inverse8"]["max_abs_depth_err"], "ms": b5["inverse8"]["ms"],
         "device_ms": b5["inverse8"]["device_ms"], "plain_ms": b5["inverse8"]["plain_ms"], "bound_ms": b5["inverse8"]["bound_ms"],
         "bound_by": b5["inverse8"]["bound_by"], "library_ms": None},
    ]
    for row, key in zip(kernels, ("B1 rasterize", "B2 gather_rows", "B3 scatter_rows", "B4 window_accum",
                                  "B5 rasterize_lines")):
        row["launches_by_path"] = paths(key)
    emit({"kernels": kernels})
    if "jax" in sys.modules or "drtk_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
