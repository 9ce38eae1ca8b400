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
    "RedisStorage",
    "as_filter",
]


def __getattr__(name):
    # RedisStorage pulls in the optional redis dependency lazily.
    if name == "RedisStorage":
        from .redis import RedisStorage

        return RedisStorage
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
