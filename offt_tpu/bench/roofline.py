"""Roofline lower bound for 3-D FFTs on the card, keyed by ``device_kind``.

An FFT is bound by memory traffic, not arithmetic, on this card, so the
bound is the larger of two times: device-memory traffic (at least one read
and one write of every local element) and, on a mesh, the two pencil
exchanges over NVLink. A device that is not in :data:`DEVICES` is an error:
no peak is ever assumed.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_gbps: float     # device-memory bandwidth, GB/s
    link_gbps: float    # NVLink to the other cards, one direction, GB/s
    source: str


# Published peaks, keyed by jax.Device.device_kind.
DEVICES = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "H100 SXM", hbm_gbps=3350.0, link_gbps=450.0,
        source="NVIDIA H100 data sheet, SXM5 part: 80 GB HBM3 at "
               "3.35 TB/s; NVLink 900 GB/s total, 450 GB/s each way "
               "(rates at the 700 W power limit)"),
}


def device_spec(device_kind: str) -> DeviceSpec:
    """The peak table's row for ``device_kind``; ValueError when unknown."""
    try:
        return DEVICES[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(DEVICES)}") from None


@dataclasses.dataclass
class Roofline:
    t_hbm_s: float
    t_link_s: float

    @property
    def t_bound_s(self) -> float:
        # perfect overlap of memory traffic and exchanges
        return max(self.t_hbm_s, self.t_link_s)

    @property
    def bound(self) -> str:
        return "hbm" if self.t_hbm_s >= self.t_link_s else "nvlink"

    def efficiency(self, measured_s: float) -> float:
        return self.t_bound_s / measured_s


def fft3d_roofline(
    shape: tuple[int, int, int],
    device_kind: str,
    p1: int = 1,
    p2: int = 1,
    bytes_per_el: int = 8,          # complex64
    hbm_passes: float = 1.0,        # read + write of every element
) -> Roofline:
    """Per-card time lower bound for one 3-D c2c transform."""
    dev = device_spec(device_kind)
    nx, ny, nz = shape
    local = nx * ny * nz / (p1 * p2)
    t_hbm = hbm_passes * 2 * local * bytes_per_el / (dev.hbm_gbps * 1e9)
    # two exchange phases; each sends (1 - 1/p_axis) of the local volume
    vol = sum(local * bytes_per_el * (1 - 1 / q) for q in (p1, p2) if q > 1)
    t_link = vol / (dev.link_gbps * 1e9)
    return Roofline(t_hbm_s=t_hbm, t_link_s=t_link)
