"""The row-sharded pipeline of drtk_tpu_torch (CPU, Gloo) against the port
on one process and against drtk_tpu's ``make_row_sharded_forward``.

Ranks are spawned with ``torch.multiprocessing.spawn`` on the Gloo backend
with a FileStore under the test's temporary directory (no ports, so
parallel test workers cannot clash); one spawn per world size (2 and 4)
runs every case of that size, and each rank writes its block, index block
and gradients to an ``.npz`` that the test process compares. The children
import this module, which imports no JAX: JAX is imported inside the
functions that compute the references.

Cases: (1, 2) and (1, 4) meshes and a (2, 2) mesh with batch 2 (jittered
cameras, as ``tests/test_spmd.py``), and a (1, 2) mesh over two of four
ranks; the two-triangles scene at 96^2 and the grid mesh at 64^2, in
float32 and float64.

Tolerances: the blocks are viewports, so index and image blocks equal the
one-process frame's rows bit for bit; gradients, summed per rank and then
over the ranks, agree with the one-process port to 1e-5 (f32) and 1e-12
(f64) of the largest magnitude; against JAX's sharded pipeline the index
is equal, the image within 1e-6 (JAX's float32 image taken outside jit,
see ``_jax_reference``) and gradients within 1e-5 (f32) and 1e-10 (f64)
(``tests/test_sharding.py:105-151``: XLA contracts FMAs).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import drtk_tpu_torch as tt
from drtk_tpu_torch.parallel import multihost, sharding, spmd

CASES = {
    # name: (world, n_devices, batch, scene, size, dtype)
    "p2_two_triangles_f64": (2, 2, 1, "two_triangles", 96, "float64"),
    "p2_grid_f32": (2, 2, 1, "grid_mesh", 64, "float32"),
    "p4_two_triangles_f32": (4, 4, 1, "two_triangles", 96, "float32"),
    "p4_grid_f64": (4, 4, 1, "grid_mesh", 64, "float64"),
    "d2p2_two_triangles_f32": (4, 4, 2, "two_triangles", 96, "float32"),
    "sub_p2_of_4_grid_f32": (4, 2, 1, "grid_mesh", 64, "float32"),
}
# The cases also run through JAX's shard_map pipeline on as many devices.
JAX_CASES = ["p2_two_triangles_f64", "p4_grid_f64", "d2p2_two_triangles_f32"]
LEAVES = ("v", "vt", "tex")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread in the test process, as
    ``tests/test_torch_kernels.py``'s fixture (not imported from there: the
    spawned ranks import this module, and that one imports more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene_arrays(name):
    """The case's scene as numpy (``tests/test_spmd.py:_scene``)."""
    import jax.numpy as jnp

    from tests.test_spmd import _scene

    _, _, batch, scene, size, dtype = CASES[name]
    return {k: np.array(a) for k, a in zip(("v", "vi", "vt", "tex", "weight"),
                                            _scene(batch, size, size, scene, getattr(jnp, dtype)))}


def _count_collectives(log):
    """Wrap ``torch.distributed``'s point-to-point and all-reduce calls to
    append (op, shape) to ``log`` (in a spawned rank only)."""
    batch, reduce_ = dist.batch_isend_irecv, dist.all_reduce

    def batch_isend_irecv(ops):
        log.extend(("send" if op.op is dist.isend else "recv", tuple(op.tensor.shape)) for op in ops)
        return batch(ops)

    def all_reduce(tensor, *args, **kwargs):
        log.append(("all_reduce", tuple(tensor.shape)))
        return reduce_(tensor, *args, **kwargs)

    dist.batch_isend_irecv, dist.all_reduce = batch_isend_irecv, all_reduce


def _rank_main(rank, world, store, cases, outdir):
    """One rank: every case of this world size, each on its own mesh."""
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    multihost.initialize(f"file://{store}-unused", world, rank, backend="gloo")  # a no-op once up
    if multihost.make_pod_mesh(batch=2, device_type="cpu").shape != sharding.mesh_shape(world, 2):
        raise AssertionError("make_pod_mesh: not the (data, pix) factoring of the world")
    log = []
    _count_collectives(log)
    try:
        for name, arrays in cases:
            _, n_dev, batch, _, size, _ = CASES[name]
            mesh = sharding.make_mesh(n_dev, batch=batch, device_type="cpu")
            if mesh.get_coordinate() is None:
                continue
            d, j = mesh.get_coordinate()
            data, pix = mesh.shape
            nb, hb = batch // data, size // pix
            t = {k: torch.from_numpy(a) for k, a in arrays.items()}
            leaves = {k: t[k][d * nb:(d + 1) * nb].clone().requires_grad_() for k in LEAVES}
            vi = t["vi"]
            fwd = spmd.make_row_sharded_forward(mesh, vi, size, size)
            block = fwd(leaves["v"], leaves["vt"], leaves["tex"])
            rows = slice(j * hb, (j + 1) * hb)
            loss = (block * t["weight"][d * nb:(d + 1) * nb, :, rows]).sum()
            del log[:]
            grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES])
            collectives = list(log)
            index = tt.rasterize(leaves["v"].detach(), vi, hb, size, y_offset=j * hb, full_height=size)
            frame = spmd.gather_frame(block, mesh)
            shard = sharding.pipeline_sharding(mesh)
            idx_full = tt.rasterize(t["v"], vi, size, size)
            idx_local = sharding.constrain(idx_full, mesh, shard["index"]).to_local()
            img_dt = sharding.constrain(frame, mesh, shard["image"])
            img_local = img_dt.to_local()
            img_whole = sharding.constrain(img_dt, mesh, sharding.replicated(mesh)).to_local()
            v_local = sharding.constrain(t["v"], mesh, shard["verts"]).to_local()
            np.savez(
                os.path.join(outdir, f"{name}_rank{rank}.npz"),
                coord=np.array([d, j]), block=block.detach().numpy(), index=index.numpy(),
                frame=frame.numpy(), idx_local=idx_local.numpy(), img_local=img_local.numpy(), img_whole=img_whole.numpy(),
                v_local=v_local.numpy(), collectives=np.array(json.dumps(collectives)),
                **{f"grad_{k}": g.numpy() for k, g in zip(LEAVES, grads)},
            )
    finally:
        dist.destroy_process_group()


def _spawn(world, outdir):
    names = [n for n, c in CASES.items() if c[0] == world]
    cases = [(n, _scene_arrays(n)) for n in names]
    mp.spawn(_rank_main, args=(world, os.path.join(outdir, f"store{world}"), cases, outdir), nprocs=world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Directory of every rank's results: one spawn of 2 ranks and one of 4."""
    outdir = str(tmp_path_factory.mktemp("spmd"))
    for world in (2, 4):
        _spawn(world, outdir)
    return outdir


def _ranks(runs, name):
    world, n_dev = CASES[name][:2]
    out = []
    for rank in range(n_dev):
        with np.load(os.path.join(runs, f"{name}_rank{rank}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    for rank in range(n_dev, world):
        assert not os.path.exists(os.path.join(runs, f"{name}_rank{rank}.npz"))
    return out


def _port_reference(arrays):
    """The one-process port: frame, index and gradients of sum(img * w)."""
    from drtk_tpu_torch.pipeline import render_textured

    t = {k: torch.from_numpy(a) for k, a in arrays.items()}
    leaves = [t[k].clone().requires_grad_() for k in LEAVES]
    size = arrays["weight"].shape[-1]
    img, idx = render_textured(*leaves[:1], t["vi"], *leaves[1:], size, size, device="cpu")
    grads = torch.autograd.grad((img * t["weight"]).sum(), leaves)
    return img.detach().numpy(), idx.numpy(), [g.numpy() for g in grads]


def _jax_reference(name, arrays):
    """drtk_tpu's shard_map pipeline on a mesh of as many virtual CPU
    devices as the case has ranks."""
    import jax
    import jax.numpy as jnp

    from drtk_tpu.parallel.sharding import make_mesh
    from drtk_tpu.parallel.spmd import make_row_sharded_forward

    _, n_dev, batch, _, size, _ = CASES[name]
    mesh = make_mesh(n_dev, batch=batch)
    fwd = make_row_sharded_forward(mesh, jnp.asarray(arrays["vi"]), size, size)
    args = [jnp.asarray(arrays[k]) for k in LEAVES]
    weight = jnp.asarray(arrays["weight"])
    # In float32, XLA's jit contracts FMAs: on the (2, 2) case JAX's jitted
    # image differs from its own eager one by 5.3e-6 of the largest value.
    # The port rounds as JAX's eager ops do, so the image is taken eagerly
    # (shard_map runs outside jit); float64 and the gradients are jitted.
    img = fwd(*args) if arrays["v"].dtype == np.float32 else jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fwd(*a) * weight), argnums=(0, 1, 2)))(*args)
    return np.asarray(img), [np.asarray(g) for g in grads]


def _assemble(ranks, key):
    """The [N, ..., H, W] frame from the ranks' blocks, by coordinates."""
    rows = {}
    for r in ranks:
        rows.setdefault(int(r["coord"][0]), []).append((int(r["coord"][1]), r[key]))
    return np.concatenate([np.concatenate([b for _, b in sorted(rows[d])], axis=-2) for d in sorted(rows)], 0)


def _grads_by_camera(ranks):
    """Each leaf's gradient over the batch: data row d's ranks hold cameras
    d*n .. (d+1)*n - 1, and every rank of a row holds the same sum."""
    out = []
    for k in LEAVES:
        parts = {}
        for r in ranks:
            d = int(r["coord"][0])
            if d in parts:
                np.testing.assert_array_equal(r[f"grad_{k}"], parts[d], err_msg=f"grad_{k} differs within a pix group")
            parts[d] = r[f"grad_{k}"]
        out.append(np.concatenate([parts[d] for d in sorted(parts)], 0))
    return out


def _close(got, want, tol, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err} of the largest magnitude (limit {tol})"


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_pipeline_matches_one_process(runs, name):
    arrays = _scene_arrays(name)
    ranks = _ranks(runs, name)
    img, idx, grads = _port_reference(arrays)
    np.testing.assert_array_equal(_assemble(ranks, "index"), idx)
    np.testing.assert_array_equal(_assemble(ranks, "block"), img)
    for r in ranks:
        np.testing.assert_array_equal(r["frame"], img, err_msg="gather_frame")
    tol = 1e-12 if CASES[name][5] == "float64" else 1e-5
    for k, got, want in zip(LEAVES, _grads_by_camera(ranks), grads):
        _close(got, want, tol, f"grad_{k}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_pipeline_matches_jax(runs, name):
    arrays = _scene_arrays(name)
    ranks = _ranks(runs, name)
    img_j, grads_j = _jax_reference(name, arrays)
    _, idx, _ = _port_reference(arrays)
    import drtk_tpu as dt

    idx_j = np.asarray(dt.rasterize(arrays["v"], arrays["vi"], *arrays["weight"].shape[-2:]))
    np.testing.assert_array_equal(_assemble(ranks, "index"), idx_j)
    np.testing.assert_array_equal(idx, idx_j)
    _close(_assemble(ranks, "block"), img_j, 1e-6, "image")
    tol = 1e-10 if CASES[name][5] == "float64" else 1e-5
    for k, got, want in zip(LEAVES, _grads_by_camera(ranks), grads_j):
        _close(got, want, tol, f"grad_{k}")


@pytest.mark.parametrize("name", ["p4_two_triangles_f32", "d2p2_two_triangles_f32"])
def test_pipeline_sharding_places_the_blocks(runs, name):
    """``pipeline_sharding``'s DTensor placements give each rank the rows
    and cameras of its spmd block: the index and image shards, and the
    vertices replicated over pix; ``constrain`` to ``replicated`` gathers
    the image back whole."""
    arrays = _scene_arrays(name)
    batch = CASES[name][2]
    for r in _ranks(runs, name):
        np.testing.assert_array_equal(r["idx_local"], r["index"])
        np.testing.assert_array_equal(r["img_local"], r["block"])
        np.testing.assert_array_equal(r["img_whole"], r["frame"])
        d = int(r["coord"][0])
        nb = batch // (2 if name.startswith("d2") else 1)
        np.testing.assert_array_equal(r["v_local"], arrays["v"][d * nb:(d + 1) * nb])


@pytest.mark.parametrize("name", ["p2_grid_f32", "p4_two_triangles_f32", "d2p2_two_triangles_f32"])
def test_collective_inventory_of_one_backward(runs, name):
    """One backward per rank: the halo, four one-row tensors (img,
    cotangent, bary, index) sent to the previous rank and four received
    from the next, and one all-reduce per replicated input (v, vt, tex) of
    its own shape; nothing else (``tests/test_spmd.py:177``)."""
    arrays = _scene_arrays(name)
    _, n_dev, batch, _, size, _ = CASES[name]
    ranks = _ranks(runs, name)
    pix = max(int(r["coord"][1]) for r in ranks) + 1
    nb = batch // (n_dev // pix)
    row_shapes = [(nb, 3, 1, size), (nb, 3, 1, size), (nb, 3, 1, size), (nb, 1, size)]
    for r in ranks:
        j = int(r["coord"][1])
        got = [(op, list(shape)) for op, shape in json.loads(str(r["collectives"]))]
        want = ([("send", list(s)) for s in row_shapes] if j > 0 else []) + (
            [("recv", list(s)) for s in row_shapes] if j < pix - 1 else [])
        want += [("all_reduce", [nb, *arrays[k].shape[1:]]) for k in ("tex", "vt", "v")]
        assert sorted(got) == sorted(want), f"rank {j}: {got}"


def test_shard_boundaries_cross_edges():
    """Guard: the cases' scenes have index discontinuities (at least two
    pixels) across every block boundary, or the halo path would go
    untested (``tests/test_sharding.py:154``)."""
    import drtk_tpu as dt

    for name in ("p2_two_triangles_f64", "p4_two_triangles_f32", "p4_grid_f64", "p2_grid_f32"):
        arrays = _scene_arrays(name)
        size, pix = CASES[name][4], CASES[name][1]
        index = np.asarray(dt.rasterize(arrays["v"], arrays["vi"], size, size))[0]
        for r in range(size // pix, size, size // pix):
            assert (index[r - 1] != index[r]).sum() >= 2, f"{name}: boundary {r}"
