"""Benchmark drivers and roofline model."""

from .roofline import DEVICES, DeviceSpec, Roofline, device_spec, fft3d_roofline

__all__ = ["DEVICES", "DeviceSpec", "Roofline", "device_spec",
           "fft3d_roofline"]
