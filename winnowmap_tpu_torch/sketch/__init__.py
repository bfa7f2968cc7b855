"""Weighted-minimizer sketching with the transform on the device (see
sketch/device.py)."""
from .device import sketch_device  # noqa: F401
