"""Host-side runtime of the port: the native NIfTI codec (loader.py), the
Zstandard decoder (zstd.py over zstd.cpp) and the read-only OCDBT store
(ocdbt.py) that the orbax checkpoint reader (train/orbax_read.py) uses;
native.py builds the C++ libraries with g++."""

from .loader import VolCodec, build_native, native_available

__all__ = ["VolCodec", "build_native", "native_available"]
