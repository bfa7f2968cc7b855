"""Colinear anchor chaining on the device (see chain/device.py)."""
from .device import chain_dp_auto, chain_dp_device_batch  # noqa: F401
