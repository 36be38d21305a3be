"""drtk_tpu_torch.utils.geometry against drtk_tpu.utils.geometry on the
same numpy inputs (CPU).

Tolerances: values to 1e-5 of their largest magnitude in float32 (the 2x2
inverse is an adjugate here and an LU solve in JAX, the vertex sums an
``index_add`` here and a segment sum there), 1e-12 in float64; gradients
of the normalized vertex normals and binormals to 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from drtk_tpu.utils import geometry as jgeo  # noqa: E402
from drtk_tpu_torch.interop import to_numpy  # noqa: E402
from drtk_tpu_torch.utils import geometry as tgeo  # noqa: E402
from tests.test_torch_kernels import _one_torch_thread  # noqa: E402,F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _mesh(dtype, n=2, num_v=40, num_f=60, seed=0):
    """A random mesh with per-batch positions and uvs (every face's uv
    triangle non-degenerate), vi as int32 [F, 3]."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, num_v, 3).astype(dtype)
    vt = rng.rand(n, num_v, 2).astype(dtype)
    vi = np.stack([rng.choice(num_v, 3, replace=False) for _ in range(num_f)]).astype(np.int32)
    return v, vt, vi


def _close(got, want, dtype, what=""):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(to_numpy(got) - want).max() <= TOL[dtype] * scale, what


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_face_dpdt_matches_jax(dtype):
    v, vt, vi = _mesh(dtype)
    want = jgeo.face_dpdt(jnp.asarray(v), jnp.asarray(vt), jnp.asarray(vi), jnp.asarray(vi))
    got = tgeo.face_dpdt(*_t(v, vt, vi, vi))
    assert got[0].shape == (2, 60, 2, 3) and got[1].shape == (2, 60, 3, 3)
    _close(got[0], want[0], dtype, "dpdt")
    np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("vi_rank", [2, 3])
def test_face_attribute_to_vert_matches_jax(vi_rank, dtype):
    v, _, vi = _mesh(dtype)
    attr = np.random.RandomState(1).randn(2, vi.shape[0], 4).astype(dtype)
    vi_in = vi if vi_rank == 2 else np.stack([vi, np.roll(vi, 1, axis=0)])
    want = jgeo.face_attribute_to_vert(jnp.asarray(v), jnp.asarray(vi_in), jnp.asarray(attr))
    got = tgeo.face_attribute_to_vert(*_t(v, vi_in, attr))
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == (2, 40, 4)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("to_compute", [None, ["normals"], ["edges"], ["areas"], ["areas", "edges"]])
def test_face_info_matches_jax(to_compute, dtype):
    v, _, vi = _mesh(dtype)
    want = jgeo.face_info(jnp.asarray(v), jnp.asarray(vi), to_compute)
    got = tgeo.face_info(*_t(v, vi), to_compute)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], dtype, k)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vert_normals_and_binormals_match_jax(dtype):
    v, vt, vi = _mesh(dtype)
    _close(tgeo.vert_normals(*_t(v, vi)), jgeo.vert_normals(jnp.asarray(v), jnp.asarray(vi)), dtype, "normals")
    _close(tgeo.vert_binormals(*_t(v, vt, vi, vi)),
           jgeo.vert_binormals(jnp.asarray(v), jnp.asarray(vt), jnp.asarray(vi), jnp.asarray(vi)), dtype, "binormals")
    fn = np.random.RandomState(2).randn(2, vi.shape[0], 3).astype(dtype)
    _close(tgeo.vert_normals(*_t(v, vi, fn)), jgeo.vert_normals(jnp.asarray(v), jnp.asarray(vi), jnp.asarray(fn)),
           dtype, "given face normals")


def test_vert_normals_of_an_icosahedron_point_outward():
    """An icosahedron's vertex normals are its vertex directions, and its
    face areas sum to its surface area."""
    p = (1 + 5**0.5) / 2
    ico = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                    [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], np.float64)
    ico /= np.linalg.norm(ico, axis=-1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                      [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    normals = to_numpy(tgeo.vert_normals(*_t(ico[None], faces)))[0]
    assert np.abs(np.abs((normals * ico).sum(-1)) - 1).max() < 1e-12
    edge = np.linalg.norm(ico[0] - ico[11])
    area = to_numpy(tgeo.face_info(*_t(ico[None], faces), ["areas"])).sum()
    assert area == pytest.approx(5 * 3**0.5 * edge**2, rel=1e-12)


def test_geometry_gradients_match_jax_vjp():
    """Gradients of vertex normals and binormals to the positions and uvs."""
    dtype = np.float32
    v, vt, vi = _mesh(dtype, n=1, num_v=20, num_f=24, seed=4)
    cot = np.random.RandomState(5).randn(1, 20, 3).astype(dtype)

    def jfn(v_, vt_):
        return jgeo.vert_normals(v_, jnp.asarray(vi)) + jgeo.vert_binormals(v_, vt_, jnp.asarray(vi), jnp.asarray(vi))

    _, vjp = jax.vjp(jfn, jnp.asarray(v), jnp.asarray(vt))
    want = vjp(jnp.asarray(cot))
    tv, tvt = (torch.from_numpy(a.copy()).requires_grad_() for a in (v, vt))
    out = tgeo.vert_normals(tv, torch.from_numpy(vi)) + tgeo.vert_binormals(tv, tvt, torch.from_numpy(vi),
                                                                           torch.from_numpy(vi))
    got = torch.autograd.grad(out, (tv, tvt), torch.from_numpy(cot))
    for g, w, name in zip(got, want, ("v", "vt")):
        assert np.abs(to_numpy(g) - np.asarray(w)).max() <= 1e-4 * np.abs(np.asarray(w)).max(), name


def test_face_dpdt_validation():
    v, vt, vi = _mesh(np.float32)
    with pytest.raises(ValueError, match="3D"):
        tgeo.face_dpdt(*_t(v[0], vt, vi, vi))
    with pytest.raises(ValueError, match="batch size"):
        tgeo.face_dpdt(*_t(v, vt[:1], vi, vi))
    with pytest.raises(ValueError, match="2D"):
        tgeo.face_attribute_to_vert(*_t(v, vi[None, None], np.zeros((2, 60, 3), np.float32)))
