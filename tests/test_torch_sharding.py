"""The (data, pix) mesh factoring of drtk_tpu_torch against drtk_tpu's,
and the port's surface: it exports every name of the JAX package, and
neither it nor any of its parallel modules imports JAX or the JAX package
(checked in a fresh interpreter). The sharded pipeline itself is tested in
``tests/test_torch_spmd.py``."""

import os

import pytest

torch = pytest.importorskip("torch")

from drtk_tpu_torch.parallel import sharding  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_mesh_shape_matches_jax(n, batch):
    from drtk_tpu.parallel.sharding import make_mesh

    assert sharding.mesh_shape(n, batch) == make_mesh(n, batch=batch).devices.shape


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: the package and every parallel module."""
    import subprocess
    import sys

    code = ("import sys, drtk_tpu_torch, drtk_tpu_torch.parallel.banded, drtk_tpu_torch.parallel.sharding, "
            "drtk_tpu_torch.parallel.spmd, drtk_tpu_torch.parallel.multihost, drtk_tpu_torch.scenes; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'drtk_tpu.')) or m == 'drtk_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_exports_every_name_of_the_jax_package():
    import drtk_tpu as dt
    import drtk_tpu_torch as tt

    public = {n for n in vars(dt) if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(tt, n))
    assert not missing, missing
