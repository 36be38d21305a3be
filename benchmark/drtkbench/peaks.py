"""Published peaks of the card (copy of ``chip_smoke.published_peaks``)."""

from __future__ import annotations


def published_peaks(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, float32 FLOP/s outside the tensor cores) from
    NVIDIA's data sheets for the card ``name``, dense, at the full power
    limit."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name:
        return 3.35e12, 67e12
    if "H200" in name:
        return 4.8e12, 67e12
    raise RuntimeError(f"no published peaks for {name!r}")
