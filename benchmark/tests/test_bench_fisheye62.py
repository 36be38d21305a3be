"""The ``fisheye62.fit`` cell on the CPU at a tiny size of its own (8 views
of 32^2 at focal 32 px, the configuration's framing at that canvas; a
9 x 9 grid, a 3 x 32^2 texture in 4 levels), the window left out: the
port's plain versions through the cell's checked steps against the
reference, the planted faults and the control, each judged as a run judges
it; M1's bytes bound on the first step's probe; and the lens's ``fov`` as
the reference works it out against the port's estimator."""

import numpy as np
import pytest
from test_bench_runs import CONTRACT_KEYS, _as_readings, _line

from drtkbench import harness
from reference import bfloat16, exact
from reference.fisheye62 import fisheye62_fov

CELL = "fisheye62.fit"
TINY = {"height": 32, "width": 32, "grid": 9, "texture": 32, "levels": 4, "focal": 32}


def _run(seed, fault=None, control=False):
    cell = harness.Cell(CELL, TINY)
    arrays = cell.scene(seed, "cpu")
    prog, got = harness.readings(cell, arrays, "cpu", fault)
    names = list(prog.names)
    del prog
    share = harness.reference_share(cell, arrays, names, "cpu", exact)
    if control:
        got = _as_readings(harness.reference_share(cell, arrays, names, "cpu", bfloat16))
    return _line(cell, [got], [share])


def test_sound_run_is_correct():
    line = _run(2**31 + 31)
    assert list(line) == CONTRACT_KEYS
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "pinhole_jacobian"])
def test_planted_fault_is_not_correct(fault):
    line = _run(13, fault)
    assert not line["correct"], line["checks"]


def test_control_fails_a_limit():
    line = _run(17, control=True)
    assert not line["correct"], line["checks"]


def test_m1_bytes_are_at_least_the_pixels_and_at_most_every_level():
    """Per pixel 2 + 4 + 3 + 3 + 2 floats; the levels' texels read and
    written at most once each, and some of them."""
    cell = harness.Cell(CELL, TINY)
    arrays = cell.scene(5, "cpu")
    prog, _ = harness.readings(cell, arrays, "cpu")
    state = {k: p.detach().clone() for k, p in zip(prog.names, prog.leaves)}
    metrics = harness.metric_modules(CELL)
    counted = harness.probe_counts(cell, arrays, state, "cpu", metrics)["texture_m1_roofline_lens"]
    pixels = 8 * 32 * 32 * 14 * 4
    texels = sum((32 >> i) ** 2 for i in range(4)) * 3 * 4
    assert pixels < counted <= pixels + 2 * texels


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 4_000_000_001])
def test_reference_fov_matches_the_ports_estimator(seed):
    """The reference's own root of the lens polynomial's derivative against
    ``estimate_fisheye62_fov`` on the cell's lenses: within float32
    rounding, and past 0.9 rad (the mesh reaches ~0.84 rad off each axis at
    its mean depth; the seeds' lenses turn at 0.91-1.57 rad)."""
    from drtk_tpu_torch.utils.projection import estimate_fisheye62_fov

    coeff = harness.Cell(CELL).entry.scene(harness.Cell(CELL, TINY).cfg, {}, seed)["distortion_coeff"]
    want = estimate_fisheye62_fov(coeff).numpy()
    got = fisheye62_fov(coeff)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(np.arctan(got).min()) > 0.9
