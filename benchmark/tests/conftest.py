"""The benchmark's own tests (run from the checkout's root:
``python -m pytest benchmark/tests -q``; on the card ``-m cuda``). The
cells run here on the CPU at a tiny size through the port's plain
versions; tests that need the card carry the ``cuda`` marker and skip
here."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Small sizes of each configuration for runs on the CPU: every width is the
# configuration's own but the frame, the mesh and the textures. The avatar
# frame is 128 pixels: at 32, with a 9 x 9 grid, pixel centres fall on
# triangle edges and the float32 port's vertex gradient moves by 0.5 %
# against the reference (with the same seeds, 4e-5 at 128 pixels).
TINY = {
    "inverse8": {"height": 32, "width": 32, "grid": 9, "texture": 16},
    "multiview4k": {"height": 32, "width": 32, "grid": 9, "texture": 16, "cameras": 2},
    "avatar4k": {"height": 128, "width": 128, "grid": 33, "texture": 64, "rays": 16, "msi": [2, 4, 8, 16], "bands": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
