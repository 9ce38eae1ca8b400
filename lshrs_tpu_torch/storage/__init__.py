from .base import BaseStorage, BucketOperation
from .device import DeviceStore
from .filter import as_filter
from .memory import MemoryStorage

__all__ = [
    "BaseStorage",
    "BucketOperation",
    "DeviceStore",
    "MemoryStorage",
    "as_filter",
]
