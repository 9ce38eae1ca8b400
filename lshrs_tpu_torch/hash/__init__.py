from .hasher import LSHHasher

__all__ = ["LSHHasher"]
