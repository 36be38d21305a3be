"""The benchmark's frozen scene builders equal the port's at the port's
seeds."""

import numpy as np
import pytest

from drtk_tpu_torch import scenes as port
from drtkbench import scenes


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_make_scene_arrays(seed):
    a = scenes.make_scene_arrays(64, 48, 11, seed)
    b = port.make_scene_arrays(64, 48, 11, seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_avatar4k_scene_arrays():
    a = scenes.avatar4k_scene_arrays(64, 9, 16, seed=0)
    b = port.avatar4k_scene_arrays(64, 9, 16)
    assert a.keys() == b.keys()
    for k in a:
        if k == "levels":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_inverse8_scene_arrays(seed):
    a = scenes.inverse8_scene_arrays(64, 9, 8, seed, 16)
    b = port.inverse8_scene_arrays(64, 9, 8, seed, 16)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_multiview_scene_arrays():
    a = scenes.multiview_scene_arrays(64, 9, 3, seed=4, tex_size=16)
    grid = scenes.make_scene_arrays(64, 64, 9, 4, 16)
    offsets = a["v"] - grid["v"]
    assert a["v"].shape == (3, 81, 3) and a["tex"].shape == (3, 3, 16, 16) and a["vt"].shape == (3, 81, 2)
    assert np.abs(offsets).max() <= 3.0 + 1e-3
    np.testing.assert_allclose(offsets, np.broadcast_to(offsets[:, :1], offsets.shape), atol=1e-3)  # one offset per camera
    assert not np.array_equal(a["tex"][0], a["tex"][1])


def test_large_seeds_reduce_to_numpy_seeds():
    a = scenes.make_scene_arrays(16, 16, 3, 2**32 + 5)
    b = scenes.make_scene_arrays(16, 16, 3, 5)
    np.testing.assert_array_equal(a["tex"], b["tex"])
