"""Native runtime bindings (librss_runtime.so via ctypes).

C++ handles the host-side ingestion layer — WAV parsing, windowed-sinc
resampling to 16 kHz, and the stream ring-buffer pool feeding the batched
scheduler — mirroring the reference's reliance on native code for everything
outside Python orchestration (there: Kaldi binaries + external sox;
tests/resample.py). Builds on demand with g++ if the shared library is
missing; pure-NumPy fallbacks keep the package functional without a
compiler.
"""

from .runtime import (
    NativeRuntime,
    StreamPool,
    get_runtime,
    load_wav,
    resample,
)

__all__ = ["NativeRuntime", "StreamPool", "get_runtime", "load_wav", "resample"]
