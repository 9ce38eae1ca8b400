from .base import BaseStorage, BucketOperation
from .device import DeviceStore
from .filter import IdFilter, as_filter
from .memory import MemoryStorage

__all__ = [
    "BaseStorage",
    "BucketOperation",
    "DeviceStore",
    "IdFilter",
    "MemoryStorage",
    "as_filter",
]
