from .mesh import SHARD_AXIS, available_devices, make_mesh
from .sharded import ShardedDeviceStore

__all__ = ["SHARD_AXIS", "available_devices", "make_mesh", "ShardedDeviceStore"]
