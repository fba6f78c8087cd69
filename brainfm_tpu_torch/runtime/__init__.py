"""Host-side runtime of the port: the native NIfTI codec (loader.py)."""

from .loader import VolCodec

__all__ = ["VolCodec"]
