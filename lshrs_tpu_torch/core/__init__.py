from .main import LSHRS

__all__ = ["LSHRS"]
