"""The sparse interpolation matrices of drtk_tpu_torch (CPU) against
drtk_tpu's: ``interpolation_matrix``, ``interpolation_normal_structure``,
``interpolation_normal_matrix_values`` and ``interpolation_normal_matrix``.

Both sides take the same numpy inputs. Most cases feed both a seeded index
image and barycentric image of their own (faces with two equal vertex ids
among them, background pixels, batch 1 and 3, shared and per-batch
``vi``), so the sort order within a row is exercised where it can differ;
the rest rasterize a grid mesh in general position with JAX and hand JAX's
index and barycentric images to both.

Tolerances: the pair structure, the sorted ``cols``, ``row_valid`` and
``vals`` are copies and agree bit for bit; so do both dense matrices in
float64 (one or two additions per entry, commutative). The products sum
in another order (per face with kernel B3's plain version, then folded to
vertices), so ``matvec`` and ``rmatvec`` agree to 1e-6 (f32) and 1e-12
(f64) of the largest magnitude, the normal matrix's values to 1e-5 and
1e-12; gradients to ``bary_img`` through them to 1e-10 in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import drtk_tpu as dt  # noqa: E402
from drtk_tpu.ops import interpolate as jax_interp  # noqa: E402
import drtk_tpu_torch as tt  # noqa: E402
from drtk_tpu_torch.ops import interpolate as port_interp  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401
from tests.utils import grid_mesh  # noqa: E402

V, F, H, W = 24, 40, 12, 16
PRODUCT_TOL = {np.float32: 1e-6, np.float64: 1e-12}
NORMAL_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _case(batch, dtype, shared_vi, seed=0):
    """Seeded vi (faces 0-5 with two equal vertex ids), an index image with
    ~1/4 background and barycentrics; vi [F, 3] when shared, else the same
    topology per batch element as [N, F, 3]."""
    rng = np.random.RandomState(seed)
    vi = rng.randint(0, V, (F, 3)).astype(np.int32)
    vi[:3, 1] = vi[:3, 0]
    vi[3:6, 2] = vi[3:6, 0]
    if not shared_vi:
        vi = np.broadcast_to(vi, (batch, F, 3)).copy()
    idx = rng.randint(0, F, (batch, H, W)).astype(np.int32)
    idx[rng.rand(batch, H, W) < 0.25] = -1
    bary = rng.rand(batch, 3, H, W) + 0.05
    bary = (bary / bary.sum(1, keepdims=True)).astype(dtype)
    return {"vi": vi, "idx": idx, "bary": bary}


def _rasterized_case(dtype):
    """JAX's index and barycentric images of a grid mesh in general
    position (48x40, 72 faces)."""
    v, vi = grid_mesh(40, 48, gn=7, z_amp=0.5, seed=2)
    idx = dt.rasterize(v, vi, 40, 48)
    _, bary = dt.render(v, vi, idx)
    return {"vi": np.asarray(vi), "idx": np.asarray(idx), "bary": np.asarray(bary).astype(dtype)}, int(v.shape[1])


def _both(case):
    j = {k: jnp.asarray(a) for k, a in case.items()}
    t = {k: torch.from_numpy(np.array(a)) for k, a in case.items()}
    return j, t


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err} of the largest magnitude (limit {tol})"


CASES = [(1, True), (3, True), (3, False)]


@pytest.mark.parametrize("batch,shared", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matrix_layout_is_bit_exact(dtype, batch, shared):
    j, t = _both(_case(batch, dtype, shared))
    a_j = dt.interpolation_matrix(j["vi"], j["idx"], j["bary"], V)
    a_t = tt.interpolation_matrix(t["vi"], t["idx"], t["bary"], V)
    np.testing.assert_array_equal(a_t.cols.numpy(), np.asarray(a_j.cols))
    np.testing.assert_array_equal(a_t.row_valid.numpy(), np.asarray(a_j.row_valid))
    np.testing.assert_array_equal(a_t.vals.numpy(), np.asarray(a_j.vals))
    assert a_t.vals.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype and a_t.cols.dtype == torch.int32
    cols = a_t.cols.numpy()[a_t.row_valid.numpy()]
    assert (np.diff(cols, axis=-1) >= 0).all()


@pytest.mark.parametrize("batch,shared", CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_products_match_jax(dtype, batch, shared):
    case = _case(batch, dtype, shared, seed=1)
    j, t = _both(case)
    rng = np.random.RandomState(7)
    x = rng.randn(batch, V, 4).astype(dtype)
    y = rng.randn(batch, H * W, 4).astype(dtype)
    a_j = dt.interpolation_matrix(j["vi"], j["idx"], j["bary"], V)
    a_t = tt.interpolation_matrix(t["vi"], t["idx"], t["bary"], V)
    tol = PRODUCT_TOL[dtype]
    _close(a_t.matvec(torch.from_numpy(x)), a_j.matvec(jnp.asarray(x)), tol, "matvec")
    _close(a_t.rmatvec(torch.from_numpy(y)), a_j.rmatvec(jnp.asarray(y)), tol, "rmatvec")
    dense_t, dense_j = a_t.todense().numpy(), np.asarray(a_j.todense())
    if dtype == np.float64:
        np.testing.assert_array_equal(dense_t, dense_j)
    else:
        _close(dense_t, dense_j, tol, "todense")

    nm_j = dt.interpolation_normal_matrix(j["vi"], j["idx"], j["bary"], V)
    nm_t = tt.interpolation_normal_matrix(t["vi"], t["idx"], t["bary"], V)
    np.testing.assert_array_equal(nm_t.rows.numpy(), np.asarray(nm_j.rows))
    np.testing.assert_array_equal(nm_t.cols.numpy(), np.asarray(nm_j.cols))
    ntol = NORMAL_TOL[dtype]
    _close(nm_t.vals, nm_j.vals, ntol, "normal values")
    ata = np.einsum("npi,npj->nij", dense_t, dense_t)
    _close(nm_t.todense(), ata, ntol, "normal matrix against A^T A")
    if dtype == np.float64:
        # Unique slots: one value each, so the dense forms are exact given
        # equal values.
        np.testing.assert_array_equal(
            tt.NormalMatrix(nm_t.rows, nm_t.cols, torch.from_numpy(np.array(nm_j.vals)), V).todense().numpy(),
            np.asarray(nm_j.todense()),
        )
    _close(nm_t.matvec(torch.from_numpy(x)), nm_j.matvec(jnp.asarray(x)), ntol, "normal matvec")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_products_on_a_rasterized_mesh(dtype):
    """JAX's own index image of a mesh in general position: ``matvec``
    against both packages' ``interpolate`` on foreground pixels, and the
    products against JAX."""
    case, nv = _rasterized_case(dtype)
    j, t = _both(case)
    x = np.random.RandomState(3).rand(1, nv, 3).astype(dtype)
    a_j = dt.interpolation_matrix(j["vi"], j["idx"], j["bary"], nv)
    a_t = tt.interpolation_matrix(t["vi"], t["idx"], t["bary"], nv)
    out = a_t.matvec(torch.from_numpy(x)).numpy().reshape(1, 40, 48, 3)
    img = tt.interpolate(torch.from_numpy(x), t["vi"], t["idx"], t["bary"]).movedim(1, -1).numpy()
    fg = case["idx"] >= 0
    assert fg.mean() > 0.5
    np.testing.assert_array_equal(out[fg], img[fg])
    assert (out[~fg] == 0).all()
    tol = PRODUCT_TOL[dtype]
    _close(a_t.matvec(torch.from_numpy(x)), a_j.matvec(jnp.asarray(x)), tol, "matvec")
    y = np.random.RandomState(4).randn(1, 40 * 48, 3).astype(dtype)
    _close(a_t.rmatvec(torch.from_numpy(y)), a_j.rmatvec(jnp.asarray(y)), tol, "rmatvec")
    vals_j = dt.interpolation_normal_matrix(j["vi"], j["idx"], j["bary"], nv).vals
    _close(tt.interpolation_normal_matrix(t["vi"], t["idx"], t["bary"], nv).vals, vals_j, NORMAL_TOL[dtype],
           "normal values")


@pytest.mark.parametrize("batch,shared", CASES)
def test_gradients_to_bary_match_jax(batch, shared):
    """float64: the gradient to ``bary_img`` (and to x, y) of scalars
    through the normal values, ``matvec`` and ``rmatvec``, against
    ``jax.grad`` of the same scalars."""
    case = _case(batch, np.float64, shared, seed=2)
    j, t = _both(case)
    rng = np.random.RandomState(8)
    x = rng.randn(batch, V, 2)
    y = rng.randn(batch, H * W, 2)
    s = tt.interpolation_normal_structure(t["vi"], V)
    wv = rng.randn(batch, int(s.rows.shape[0]))
    s_j = dt.interpolation_normal_structure(j["vi"], V)

    def jax_loss(bary, x, y):
        a = dt.interpolation_matrix(j["vi"], j["idx"], bary, V)
        vals = dt.interpolation_normal_matrix_values(s_j, j["vi"], j["idx"], bary)
        return (jnp.sum(vals * wv) + jnp.sum(a.matvec(x) ** 2) + jnp.sum(a.rmatvec(y) ** 3)
                + jnp.sum(jnp.sin(a.vals)))

    g_j = jax.grad(jax_loss, argnums=(0, 1, 2))(j["bary"], jnp.asarray(x), jnp.asarray(y))
    leaves = [t["bary"].clone().requires_grad_(), torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(y).requires_grad_()]
    a = tt.interpolation_matrix(t["vi"], t["idx"], leaves[0], V)
    vals = tt.interpolation_normal_matrix_values(s, t["vi"], t["idx"], leaves[0])
    loss = ((vals * torch.from_numpy(wv)).sum() + (a.matvec(leaves[1]) ** 2).sum()
            + (a.rmatvec(leaves[2]) ** 3).sum() + torch.sin(a.vals).sum())
    g_t = torch.autograd.grad(loss, leaves)
    for name, got, want in zip(("bary", "x", "y"), g_t, g_j):
        _close(got, want, 1e-10, f"gradient to {name}")


@pytest.mark.parametrize("f_cnt,v_cnt", [(1, 3), (17, 12), (400, 100), (1000, 50)])
def test_pair_structure_matches_jax(f_cnt, v_cnt):
    """The sizes of tests/test_native.py, against the JAX package's pair
    structure (its native library where it compiles, else its numpy twin)."""
    vi = np.random.RandomState(0).randint(0, v_cnt, (f_cnt, 3)).astype(np.int32)
    want = jax_interp._build_normal_structure(vi, v_cnt)
    got = port_interp.build_pair_structure(vi, v_cnt)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vi,v_cnt", [
    (np.array([[0, 1, 5]], np.int32), 3),
    (np.array([[0, -1, 2]], np.int32), 3),
    (np.zeros((2, 4), np.int32), 3),
    (np.zeros((2, 3), np.float32), 3),
    (np.zeros((2, 3), np.int32), 0),
])
def test_pair_structure_rejects_bad_topology(vi, v_cnt):
    with pytest.raises(ValueError):
        port_interp.build_pair_structure(vi, v_cnt)
    with pytest.raises(ValueError):
        tt.interpolation_normal_structure(torch.from_numpy(vi), v_cnt)


def test_structure_is_cached_and_reused_across_frames():
    """One structure serves two rasterizations (``tests/test_interpolate.py:
    152``): the second lookup is a cache hit, and the value-only recompute
    equals ``interpolation_normal_matrix``'s values on both frames, and
    JAX's."""
    v, vi = grid_mesh(24, 24, gn=5, seed=1)
    nv = int(v.shape[1])
    vi_t = torch.from_numpy(np.array(vi))
    s1 = tt.interpolation_normal_structure(vi_t, nv)
    cached = len(port_interp._STRUCTURE_CACHE)
    s2 = tt.interpolation_normal_structure(vi_t.clone(), nv)
    assert s2 is s1 and len(port_interp._STRUCTURE_CACHE) == cached
    for shift in ([0.0, 0.0, 0.0], [0.7, -1.3, 0.2]):
        vs = v + jnp.asarray(shift)
        idx = dt.rasterize(vs, vi, 24, 24)
        _, bary = dt.render(vs, vi, idx)
        idx_t, bary_t = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(bary))
        vals = tt.interpolation_normal_matrix_values(s1, vi_t, idx_t, bary_t)
        full = tt.interpolation_normal_matrix(vi_t, idx_t, bary_t, nv)
        assert full.rows is s1.rows
        torch.testing.assert_close(vals, full.vals, rtol=0, atol=0)
        _close(vals, dt.interpolation_normal_matrix(vi, idx, bary, nv).vals, 1e-5, "normal values")


def test_structure_cache_evicts_the_least_recently_used():
    port_interp._STRUCTURE_CACHE.clear()
    first = tt.interpolation_normal_structure(torch.zeros((1, 3), dtype=torch.int32), 1)
    for v_cnt in range(2, port_interp._STRUCTURE_CACHE_MAX + 1):
        tt.interpolation_normal_structure(torch.zeros((1, 3), dtype=torch.int32), v_cnt)
    assert tt.interpolation_normal_structure(torch.zeros((1, 3), dtype=torch.int32), 1) is first  # a hit, now newest
    tt.interpolation_normal_structure(torch.zeros((1, 3), dtype=torch.int32), 500)  # evicts V = 2
    assert len(port_interp._STRUCTURE_CACHE) == port_interp._STRUCTURE_CACHE_MAX
    assert tt.interpolation_normal_structure(torch.zeros((1, 3), dtype=torch.int32), 1) is first
    assert all(key[3] != 2 for key in port_interp._STRUCTURE_CACHE)
