"""Drive drtk_tpu_torch's render path and fitting step on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, then, on the repository's
flagship scene (``textured``: 1024x1024 pixels, a 161x161-vertex grid of
51,200 triangles, per-vertex uvs, a 3x512x512 texture), renders it through
the public entry point and runs the fitting step (forward and backward, with
gradients to the vertices, the uvs and the texture), timing both with CUDA
events. Every earlier line of output is a JSON object (or the raw
nvidia-smi line); the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script then exits non-zero without that line.
It exits non-zero at once when CUDA is absent or the package is not beside
it.
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
        from drtk_tpu_torch.pipeline import BACKWARD_STAGES, FIT_STAGES, STAGES, fit_step, render_textured, stage_ms
        from drtk_tpu_torch.scenes import entry_scene, make_scene
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

    # 3. B2 vs plain on the textured scene's index image
    rng = np.random.RandomState(0)
    tables = {
        9: _face_table(v, vib),  # render's per-face vertex rows
        6: _face_table(vt, vib),  # interpolate's per-face uv rows
        16: torch.from_numpy(rng.randn(1, n_faces, 16).astype(np.float32)).to(dev),  # edge_grad's width
    }
    b2 = {}
    for k_dim, table in tables.items():
        got = segment_rows.gather_rows_by_index(table, index_img)
        want = segment_rows._gather_rows_plain(table, index_img)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B2 K={k_dim}: kernel differs from the plain gather")
        padded = torch.cat([table.new_zeros((1, k_dim)), table[0]])  # row 0 = background
        lib_idx = index_img.long() + 1
        lib_out = torch.nn.functional.embedding(lib_idx, padded)
        if not torch.equal(lib_out[0], got[0]):
            raise AssertionError(f"B2 K={k_dim}: the library yardstick computes another function")
        nbytes = table.numel() * 4 + index_img.numel() * 4 + got.numel() * 4
        b2[k_dim] = {
            "ms": cuda_ms(lambda: segment_rows._gather_rows_cuda(table, index_img), 50),
            "plain_ms": cuda_ms(lambda: segment_rows._gather_rows_plain(table, index_img), 20),
            "library_ms": cuda_ms(lambda: torch.nn.functional.embedding(lib_idx, padded), 50),
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": 0.0,
        }
        emit({"phase": "B2 vs plain", "K": k_dim, "bit_exact": True, **b2[k_dim]})

    # 4. B1 vs plain on the entry scene and the textured scene
    entry = entry_scene(h=ENTRY_HW, w=ENTRY_HW, device=dev)
    b1 = {}
    for scene, (sv, svi, hh, ww) in {"entry": (entry[0], entry[1], ENTRY_HW, ENTRY_HW),
                                    "textured": (v, vi, H, W)}.items():
        svib = rast.broadcast_vi(svi, sv.shape[0])
        setup = rast.triangle_setup(sv, svib)
        valid = rast._canvas_cull(setup, hh, ww)
        coef, meta = rasterize_cuda.pack_setup(setup, valid, hh, ww)
        d, i = rasterize_cuda.resolve_packed(coef, meta, hh, ww)
        d_ref, i_ref = rast._rasterize_plain(setup, valid, hh, ww)
        torch.cuda.synchronize()
        rec = check_raster(f"B1 {scene}", d_ref, i_ref, d, i)
        m = meta.long()
        tests = ((m[..., 2] - m[..., 1] + 1).clamp(min=0) * (m[..., 4] - m[..., 3] + 1).clamp(min=0)).sum().item()
        nbytes = coef.numel() * 4 + meta.numel() * 4 + d.numel() * 4 + i.numel() * 4
        bound_bytes_ms = nbytes / bw * 1e3
        bound_ops_ms = tests * FLOPS_PER_TEST / f32_flops * 1e3
        rec.update({
            "H": hh, "W": ww, "faces": int(svib.shape[1]),
            "ms": cuda_ms(lambda: rasterize_cuda.resolve_packed(coef, meta, hh, ww), 20),
            "plain_ms": cuda_ms(lambda: rast._rasterize_plain(setup, valid, hh, ww), 2, warmup=1),
            "rasterize_call_ms": cuda_ms(lambda: tt.rasterize_with_depth(sv, svi, hh, ww), 20),
            "pixel_centres_tested": tests, "bytes": nbytes,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        })
        b1[scene] = rec
        emit({"phase": "B1 vs plain", "scene": scene, **rec})

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
                    "B4 window_accum": 0}:
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

    # 6. B3 vs plain: rows from a seeded generator, the textured scene's index image
    gen = torch.Generator(device=dev).manual_seed(0)
    fg = index_img >= 0
    n_fg = int(fg.sum())
    b3 = {}
    for k_dim in (9, 6):
        rows = torch.randn((1, H, W, k_dim), generator=gen, device=dev)
        got = segment_rows.scatter_rows_to_faces(rows, index_img, n_faces)
        want = segment_rows._scatter_rows_plain(rows, index_img, n_faces)
        magnitude = segment_rows._scatter_rows_plain(rows.abs(), index_img, n_faces)
        lib_idx, lib_rows = index_img[fg].long(), rows[fg]

        def library(lib_idx=lib_idx, lib_rows=lib_rows, k_dim=k_dim):
            return torch.zeros((n_faces, k_dim), device=dev).index_add_(0, lib_idx, lib_rows)

        torch.cuda.synchronize()
        err = (got - want).abs()
        # atomics reorder the sums: rtol 1e-5, atol 1e-6 of the summed magnitudes
        if not bool((err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
            raise AssertionError(f"B3 K={k_dim}: kernel differs from the plain scatter by {err.max().item()}")
        if not bool(((library() - want[0]).abs() <= 1e-5 * want[0].abs() + 1e-6 * magnitude[0]).all()):
            raise AssertionError(f"B3 K={k_dim}: the library yardstick computes another function")
        nbytes = n_fg * k_dim * 4 + index_img.numel() * 4 + n_faces * k_dim * 4
        b3[k_dim] = {
            "ms": cuda_ms(lambda: segment_rows._scatter_rows_cuda(rows, index_img, n_faces), 50),
            "plain_ms": cuda_ms(lambda: segment_rows._scatter_rows_plain(rows, index_img, n_faces), 20),
            "library_ms": cuda_ms(library, 50), "library": "index_add_ of the foreground rows (the plain "
            "version's core, without its masking)", "foreground_pixels": n_fg,
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": err.max().item(),
        }
        emit({"phase": "B3 vs plain", "K": k_dim, **b3[k_dim]})

    # 7. B4 vs plain on the taps of the fitting step's own grid_sample: the
    # quad-row index of every pixel's bilinear border sample of the texture
    _, bary0 = tt.render(v, vi, index_img)
    uv = tt.interpolate(vt, vi, index_img, bary0).movedim(1, -1) * 2.0 - 1.0
    t_h, t_w = tex.shape[2:]
    bx = torch.floor(gs._compute_source_index(uv[..., 0], t_w, "border", False)).int().clamp(0, t_w - 1)
    by = torch.floor(gs._compute_source_index(uv[..., 1], t_h, "border", False)).int().clamp(0, t_h - 1)
    k4 = 4 * tex.shape[1]
    cot = torch.randn((1, H * W, k4), generator=gen, device=dev) * fg.reshape(1, -1, 1)  # zero at background
    iy = torch.where(fg, by, -1).reshape(1, -1)
    ix = bx.reshape(1, -1)
    rows_kp = cot.transpose(1, 2)  # the [N, K, P] view the row scatter passes
    got = window_accum.window_accumulate(rows_kp, iy, ix, t_h, t_w)
    want = window_accum._window_accumulate_plain(rows_kp, iy, ix, t_h, t_w)
    magnitude = window_accum._window_accumulate_plain(rows_kp.abs(), iy, ix, t_h, t_w)
    lib_flat = (by * t_w + bx)[fg].long()
    lib_rows = cot[0][fg.reshape(-1)].t().contiguous()

    def library_b4():
        return torch.zeros((k4, t_h * t_w), device=dev).index_add_(1, lib_flat, lib_rows)

    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * want.abs() + 1e-6 * magnitude).all()):
        raise AssertionError(f"B4: kernel differs from the plain scatter by {err.max().item()}")
    lib_err = (library_b4().reshape(k4, t_h, t_w) - want[0]).abs()
    if not bool((lib_err <= 1e-5 * want[0].abs() + 1e-6 * magnitude[0]).all()):
        raise AssertionError("B4: the library yardstick computes another function")
    nbytes = n_fg * k4 * 4 + iy.numel() * 4 + ix.numel() * 4 + k4 * t_h * t_w * 4
    b4 = {
        "K": k4, "taps": iy.numel(), "live_taps": n_fg, "table": [t_h, t_w],
        "ms": cuda_ms(lambda: window_accum._window_accumulate_cuda(rows_kp, iy, ix, t_h, t_w), 50),
        "plain_ms": cuda_ms(lambda: window_accum._window_accumulate_plain(rows_kp, iy, ix, t_h, t_w), 20),
        "library_ms": cuda_ms(library_b4, 50), "library": "index_add_ of the live taps' rows (the plain "
        "version's core, without its masking)",
        "bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "max_abs_err": err.max().item(),
    }
    emit({"phase": "B4 vs plain", **b4})

    # 8. The main path of this slice: the fitting step at full size, with
    # gradients to v, vt and tex, then bench_textured's v-only gradient.
    expected = {
        ("v", "vt", "tex"): {"B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 3, "B4 window_accum": 1},
        ("v",): {"B1 rasterize": 1, "B2 gather_rows": 5, "B3 scatter_rows": 2, "B4 window_accum": 0},
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

    # 9. The kernels, with the numbers of this run; times per fitting step
    # (B2: K=9 and K=6 in the forward, again in the backward, and K=16 in
    # edge_grad's backward; B3: K=9 in render's and edge_grad's backward,
    # K=6 in interpolate's).
    def b2_step(key):
        return 2 * b2[9][key] + 2 * b2[6][key] + b2[16][key]

    def b3_step(key):
        return 2 * b3[9][key] + b3[6][key]

    kernels = [
        {"name": "B1 rasterize_pallas._tile_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/rasterize.cu", "replaces": "drtk_tpu/ops/rasterize_pallas.py:257",
         "launches": main_launches["B1 rasterize"], "launches_per_step": 1,
         "max_abs_err": b1["textured"]["max_abs_depth_err"],
         "ms": b1["textured"]["ms"], "plain_ms": b1["textured"]["plain_ms"],
         "bound_ms": b1["textured"]["bound_ms"], "bound_by": b1["textured"]["bound_by"], "library_ms": None},
        {"name": "B2 segment_rows._gather_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/gather_rows.cu", "replaces": "drtk_tpu/ops/segment_rows.py:359",
         "launches": main_launches["B2 gather_rows"], "launches_per_step": 5, "max_abs_err": 0.0,
         "ms": b2_step("ms"), "plain_ms": b2_step("plain_ms"), "bound_ms": b2_step("bound_ms"),
         "bound_by": "bytes", "library_ms": b2_step("library_ms")},
        {"name": "B3 segment_rows._accumulate_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/scatter_rows.cu", "replaces": "drtk_tpu/ops/segment_rows.py:129",
         "launches": main_launches["B3 scatter_rows"], "launches_per_step": 3,
         "max_abs_err": max(b3[9]["max_abs_err"], b3[6]["max_abs_err"]),
         "ms": b3_step("ms"), "plain_ms": b3_step("plain_ms"), "bound_ms": b3_step("bound_ms"),
         "bound_by": "bytes", "library_ms": b3_step("library_ms")},
        {"name": "B4 window_accum._window_kernel", "route": "cuda",
         "source": "drtk_tpu_torch/csrc/window_accum.cu", "replaces": "drtk_tpu/ops/window_accum.py:92",
         "launches": main_launches["B4 window_accum"], "launches_per_step": 1, "max_abs_err": b4["max_abs_err"],
         "ms": b4["ms"], "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"], "bound_by": "bytes",
         "library_ms": b4["library_ms"]},
    ]
    emit({"kernels": kernels})
    if "jax" in sys.modules or "drtk_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
