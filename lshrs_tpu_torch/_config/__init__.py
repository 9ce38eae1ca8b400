from .config import HashSignatures

__all__ = ["HashSignatures"]
