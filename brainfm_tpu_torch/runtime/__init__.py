"""Host-side runtime of the port: the native NIfTI codec (loader.py)."""

from .loader import VolCodec, build_native, native_available

__all__ = ["VolCodec", "build_native", "native_available"]
