"""ctypes bindings for librss_runtime.so with NumPy fallbacks."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LOGGER = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
# the port's own build of the shared source: the JAX package builds and
# loads native/build/librss_runtime.so
_LIB_PATH = Path(__file__).resolve().parent / "build" / "librss_runtime.so"
# "<-march target> <host key>" of the build ("generic" without -march)
_STAMP_PATH = _LIB_PATH.with_suffix(".march")


def _host_key() -> str:
    """The machine type and a digest of the instruction-set flags the CPU
    reports in /proc/cpuinfo (what ``-march=native`` resolves from), read
    without starting a compiler."""
    flags = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[-1]
                    break
    except OSError:
        pass
    digest = hashlib.sha256(" ".join(sorted(flags.split())).encode()).hexdigest()[:16]
    return f"{platform.machine()}-{digest}"


def _march_target() -> str:
    """What ``-march=native`` resolves to on this host, as g++ reports it,
    or ``generic`` when g++ cannot say."""
    try:
        out = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            check=True, capture_output=True, text=True,
        ).stdout
    except (subprocess.CalledProcessError, FileNotFoundError):
        return "generic"
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return "generic"


def _build_library() -> Optional[Path]:
    """Compile the shared library with g++ (no cmake round-trip needed)
    for this host's ``-march=native`` target, or without ``-march`` when
    that fails or g++ names no target; stamp the target and the host key
    beside it."""
    src = _NATIVE_DIR / "rss_runtime.cpp"
    if not src.exists():
        return None
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    # concurrent builders each write their own file and rename it over the
    # library, so no process loads a half-written one
    tmp = _LIB_PATH.with_name(f".{os.getpid()}.{_LIB_PATH.name}")
    # the ADPCM wire encoder leans on AVX-512 when the host has it; the
    # stamp makes a host of other instructions rebuild
    err = None
    for want in dict.fromkeys([_march_target(), "generic"]):  # generic: cross/odd toolchains
        march = [] if want == "generic" else ["-march=native"]
        cmd = [
            "g++", "-O3", "-fPIC", "-shared", "-std=c++17", *march,
            str(src), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            err = exc
            continue
        os.replace(tmp, _LIB_PATH)
        _STAMP_PATH.write_text(f"{want} {_host_key()}\n", encoding="utf-8")
        return _LIB_PATH
    _LOGGER.warning("native build failed (%s); using NumPy fallbacks", err)
    return None


def _stamp() -> Tuple[Optional[str], Optional[str]]:
    """(target, host key) stamped beside the library; (None, None) without
    a stamp of both."""
    try:
        fields = _STAMP_PATH.read_text(encoding="utf-8").split()
    except FileNotFoundError:
        return None, None
    return (fields[0], fields[1]) if len(fields) == 2 else (None, None)


class NativeRuntime:
    """Lazy-loaded library handle."""

    def __init__(self):
        self._lib = None
        self._tried = False
        self._lock = threading.Lock()

    @property
    def lib(self):
        with self._lock:
            if self._lib is None and not self._tried:
                self._tried = True
                src = _NATIVE_DIR / "rss_runtime.cpp"
                stale = (
                    _LIB_PATH.exists()
                    and src.exists()
                    and src.stat().st_mtime > _LIB_PATH.stat().st_mtime
                )
                built_for, built_on = _stamp()
                here = built_on == _host_key()
                path = (
                    _LIB_PATH
                    if _LIB_PATH.exists() and not stale and here
                    else _build_library()
                )
                if path is None and _LIB_PATH.exists() and (here or built_for == "generic"):
                    # rebuild of a stale library failed (no compiler?):
                    # the older build still works — newer entry points
                    # are hasattr-guarded by callers — unless it was built
                    # for another host's instructions
                    path = _LIB_PATH
                if path is not None:
                    try:
                        lib = ctypes.CDLL(str(path))
                        self._configure(lib)
                        self._lib = lib
                    except (OSError, AttributeError) as err:
                        # a stale build missing required symbols (rebuild
                        # failed on a compiler-less host) must degrade to
                        # the NumPy fallbacks, not crash the caller
                        _LOGGER.warning(
                            "native library %s unusable (%s); using "
                            "NumPy fallbacks", path, err,
                        )
                        self._lib = None
            return self._lib

    @staticmethod
    def _configure(lib) -> None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rss_wav_info.restype = ctypes.c_int
        lib.rss_wav_info.argtypes = [
            u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rss_wav_decode.restype = ctypes.c_int
        lib.rss_wav_decode.argtypes = [u8p, ctypes.c_int64, f32p, ctypes.c_int64]
        lib.rss_resample_out_len.restype = ctypes.c_int64
        lib.rss_resample_out_len.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32
        ]
        lib.rss_resample.restype = ctypes.c_int
        lib.rss_resample.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32p
        ]
        lib.rss_pool_create.restype = ctypes.c_void_p
        lib.rss_pool_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
        lib.rss_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.rss_pool_open.restype = ctypes.c_int32
        lib.rss_pool_open.argtypes = [ctypes.c_void_p]
        lib.rss_pool_feed.restype = ctypes.c_int64
        lib.rss_pool_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, f32p, ctypes.c_int64
        ]
        lib.rss_pool_finish.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.rss_pool_available.restype = ctypes.c_int64
        lib.rss_pool_available.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.rss_pool_is_finished.restype = ctypes.c_int32
        lib.rss_pool_is_finished.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.rss_pool_read.restype = ctypes.c_int64
        lib.rss_pool_read.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, f32p, ctypes.c_int64
        ]
        lib.rss_pool_close.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        if hasattr(lib, "rss_pool_snapshot"):
            lib.rss_pool_snapshot.argtypes = [ctypes.c_void_p, i64p, i32p]
            lib.rss_pool_read_all.restype = ctypes.c_int32
            lib.rss_pool_read_all.argtypes = [
                ctypes.c_void_p, f32p, i16p, ctypes.c_int32,
                ctypes.c_int64, i64p, i64p,
            ]
        if hasattr(lib, "rss_pool_feed_i16"):
            lib.rss_pool_feed_i16.restype = ctypes.c_int64
            lib.rss_pool_feed_i16.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, i16p, ctypes.c_int64
            ]
        if hasattr(lib, "rss_pool_open_at"):
            lib.rss_pool_open_at.restype = ctypes.c_int32
            lib.rss_pool_open_at.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        if hasattr(lib, "rss_pool_read_all_mulaw"):
            lib.rss_pool_read_all_mulaw.restype = ctypes.c_int32
            lib.rss_pool_read_all_mulaw.argtypes = [
                ctypes.c_void_p, u8p, ctypes.c_int64, i64p, i64p,
            ]
        if hasattr(lib, "rss_adpcm_encode_blocks"):
            lib.rss_adpcm_encode_blocks.restype = ctypes.c_int32
            lib.rss_adpcm_encode_blocks.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, i64p,
                ctypes.c_int64, u8p, ctypes.c_int64,
            ]
        if hasattr(lib, "rss_pool_feed_i16_many"):
            lib.rss_pool_feed_i16_many.restype = ctypes.c_int32
            lib.rss_pool_feed_i16_many.argtypes = [
                ctypes.c_void_p, i32p,
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                ctypes.c_int32, i64p,
            ]


_RUNTIME = NativeRuntime()


def get_runtime() -> NativeRuntime:
    return _RUNTIME


def adpcm_encode_into(
    samples: np.ndarray, lens: np.ndarray, block: int, out: np.ndarray
) -> None:
    """4-bit block-ADPCM encode for the serving wire: [N, W] float32
    ``samples`` (C-contiguous) -> uint8 wire rows in ``out`` (a column
    view into the upload batch is fine — the row stride is taken from
    ``out.strides``), with the reconstructed values written back IN
    PLACE over ``samples`` (the scheduler carries frame-overlap tails
    from them). Native encoder when available, byte-identical
    ops.adpcm reference otherwise."""
    if samples.dtype != np.float32 or out.dtype != np.uint8:
        raise TypeError(
            f"adpcm_encode_into takes float32 samples and uint8 out, got "
            f"{samples.dtype} and {out.dtype}"
        )
    if not samples.flags.c_contiguous:
        raise ValueError("adpcm_encode_into: samples must be C-contiguous")
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    lib = get_runtime().lib
    if lib is not None and hasattr(lib, "rss_adpcm_encode_blocks"):
        rc = lib.rss_adpcm_encode_blocks(
            _f32p(samples),
            samples.shape[0],
            samples.shape[1],
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            block,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.strides[0],
        )
        if rc != 0:
            raise RuntimeError("rss_adpcm_encode_blocks: bad block/width")
        return
    from ..ops.adpcm import encode_blocks

    encode_blocks(samples, lens, block, out)


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """WAV file -> mono float32 at target_rate (native parse + resample;
    stdlib-wave fallback)."""
    lib = _RUNTIME.lib
    data = np.fromfile(path, dtype=np.uint8)
    if lib is not None:
        rate = ctypes.c_int32()
        channels = ctypes.c_int32()
        num_samples = ctypes.c_int64()
        rc = lib.rss_wav_info(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            data.shape[0],
            ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(num_samples),
        )
        if rc == 0:
            pcm = np.empty(num_samples.value, dtype=np.float32)
            rc = lib.rss_wav_decode(
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                data.shape[0], _f32p(pcm), num_samples.value,
            )
            if rc == 0:
                if rate.value != target_rate:
                    pcm = resample(pcm, rate.value, target_rate)
                return pcm
        _LOGGER.warning("native WAV parse failed rc=%s for %s", rc, path)

    import wave

    with wave.open(path, "rb") as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1)
        pcm = raw.astype(np.float32)
        if w.getframerate() != target_rate:
            pcm = resample(pcm, w.getframerate(), target_rate)
        return pcm


def resample(pcm: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """Windowed-sinc rational resampling (native; NumPy fallback)."""
    if in_rate == out_rate:
        return pcm
    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    lib = _RUNTIME.lib
    if lib is not None:
        out_len = lib.rss_resample_out_len(pcm.shape[0], in_rate, out_rate)
        out = np.empty(out_len, dtype=np.float32)
        rc = lib.rss_resample(_f32p(pcm), pcm.shape[0], in_rate, out_rate, _f32p(out))
        if rc == 0:
            return out

    # NumPy fallback: same windowed-sinc math
    import math

    g = math.gcd(in_rate, out_rate)
    up, down = out_rate // g, in_rate // g
    n = pcm.shape[0]
    out_len = (n * out_rate) // in_rate
    fc = 0.45 * min(in_rate, out_rate) / in_rate
    support = 16 / (2 * fc)
    out = np.zeros(out_len, dtype=np.float32)
    for j in range(out_len):
        center = j * down / up
        lo = max(int(np.ceil(center - support)), 0)
        hi = min(int(np.floor(center + support)), n - 1)
        x = np.arange(lo, hi + 1) - center
        arg = 2 * np.pi * fc * x
        safe_arg = np.where(np.abs(arg) < 1e-9, 1.0, arg)
        sinc = np.where(np.abs(arg) < 1e-9, 1.0, np.sin(safe_arg) / safe_arg)
        win = 0.5 + 0.5 * np.cos(np.pi * x / (support + 1e-9))
        w = sinc * win
        norm = w.sum()
        out[j] = float((w * pcm[lo : hi + 1]).sum() / norm) if norm > 1e-12 else 0.0
    return out


class StreamPool:
    """Fixed-slot PCM ring-buffer pool (native; NumPy fallback)."""

    def __init__(self, num_slots: int, capacity_samples: int = 16000 * 30):
        self._lib = _RUNTIME.lib
        self.num_slots = num_slots
        self.capacity = capacity_samples
        if self._lib is not None:
            self._handle = ctypes.c_void_p(
                self._lib.rss_pool_create(num_slots, capacity_samples)
            )
        else:
            self._buffers = [None] * num_slots
            self._finished = [False] * num_slots
            self._lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.rss_pool_destroy(self._handle)

    def open(self) -> int:
        if self._lib is not None:
            return int(self._lib.rss_pool_open(self._handle))
        with self._lock:
            for i, buf in enumerate(self._buffers):
                if buf is None:
                    self._buffers[i] = np.zeros(0, dtype=np.float32)
                    self._finished[i] = False
                    return i
            return -1

    def open_at(self, slot: int) -> int:
        """Open a SPECIFIC slot (mesh-aware admission); -1 when occupied."""
        if self._lib is not None:
            if hasattr(self._lib, "rss_pool_open_at"):
                return int(self._lib.rss_pool_open_at(self._handle, slot))
            return -1  # stale native build: caller falls back to open()
        with self._lock:
            if not 0 <= slot < self.num_slots or self._buffers[slot] is not None:
                return -1
            self._buffers[slot] = np.zeros(0, dtype=np.float32)
            self._finished[slot] = False
            return slot

    def feed(self, slot: int, pcm: np.ndarray) -> int:
        """Append PCM. int16 input (the wire format) takes a dedicated
        native path: widened into the ring without the per-sample f32
        exactness scan — at hundreds of lanes the scan was the feed
        loop's hot cost."""
        if (
            pcm.dtype == np.int16
            and self._lib is not None
            and hasattr(self._lib, "rss_pool_feed_i16")
        ):
            pcm = np.ascontiguousarray(pcm)
            return int(
                self._lib.rss_pool_feed_i16(
                    self._handle,
                    slot,
                    pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    pcm.shape[0],
                )
            )
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        if self._lib is not None:
            return int(self._lib.rss_pool_feed(self._handle, slot, _f32p(pcm), pcm.shape[0]))
        with self._lock:
            self._buffers[slot] = np.concatenate([self._buffers[slot], pcm])
            return pcm.shape[0]

    def feed_many(self, slots: np.ndarray, pcm: np.ndarray) -> np.ndarray:
        """Batched int16 feed: row k of ``pcm`` [count, n] goes to
        ``slots[k]`` in ONE native call (one lock, no per-lane ctypes
        overhead — the serving loop's per-tick ingest). Returns samples
        accepted per row (-1 for inactive/finished slots). Falls back to
        per-slot ``feed`` without the native entry point."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        assert pcm.ndim == 2 and pcm.shape[0] == slots.shape[0]
        if self._lib is not None and hasattr(
            self._lib, "rss_pool_feed_i16_many"
        ):
            taken = np.empty(slots.shape[0], dtype=np.int64)
            self._lib.rss_pool_feed_i16_many(
                self._handle,
                slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                pcm.shape[1],
                slots.shape[0],
                taken.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            return taken
        taken = np.full(slots.shape[0], -1, dtype=np.int64)
        for k, s in enumerate(slots):
            s = int(s)
            if not 0 <= s < self.num_slots:
                continue
            if self._lib is None:
                with self._lock:
                    dead = self._buffers[s] is None or self._finished[s]
                if dead:
                    continue
            taken[k] = self.feed(s, pcm[k])
        return taken

    def finish(self, slot: int) -> None:
        if self._lib is not None:
            self._lib.rss_pool_finish(self._handle, slot)
        else:
            self._finished[slot] = True

    def available(self, slot: int) -> int:
        if self._lib is not None:
            return int(self._lib.rss_pool_available(self._handle, slot))
        with self._lock:
            return self._buffers[slot].shape[0]

    def is_finished(self, slot: int) -> bool:
        if self._lib is not None:
            return bool(self._lib.rss_pool_is_finished(self._handle, slot))
        return self._finished[slot]

    def read(self, slot: int, n: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(n, dtype=np.float32)
            got = int(self._lib.rss_pool_read(self._handle, slot, _f32p(out), n))
            return out[:got]
        with self._lock:
            buf = self._buffers[slot]
            out = buf[:n].copy()
            self._buffers[slot] = buf[n:]
            return out

    def close(self, slot: int) -> None:
        if self._lib is not None:
            self._lib.rss_pool_close(self._handle, slot)
        else:
            with self._lock:
                self._buffers[slot] = None

    @property
    def has_batched_drain(self) -> bool:
        return self._lib is not None and hasattr(self._lib, "rss_pool_snapshot")

    def snapshot(self):
        """(counts [N] int64, finished [N] bool, i16_exact [N] bool) in
        ONE native call — the batched scheduler's per-tick drain plan.
        i16_exact marks slots whose every fed sample round-trips through
        int16 (tracked at feed time; always False on the NumPy fallback,
        which makes the caller take the float32 upload path)."""
        N = self.num_slots
        if self._lib is not None and self.has_batched_drain:
            counts = np.zeros(N, dtype=np.int64)
            flags = np.zeros(N, dtype=np.int32)
            self._lib.rss_pool_snapshot(
                self._handle,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return (
                counts,
                (flags & 2).astype(bool),
                (flags & 4).astype(bool),
            )
        if self._lib is not None:
            counts = np.array(
                [self.available(i) for i in range(N)], dtype=np.int64
            )
        else:
            with self._lock:
                counts = np.array(
                    [
                        b.shape[0] if b is not None else 0
                        for b in self._buffers
                    ],
                    dtype=np.int64,
                )
        finished = np.array(
            [self.is_finished(i) for i in range(N)], dtype=bool
        )
        return counts, finished, np.zeros(N, dtype=bool)

    def read_into(
        self,
        out: np.ndarray,
        offs: np.ndarray,
        counts: np.ndarray,
    ) -> None:
        """Drain counts[i] samples from each slot into out[i, offs[i]:]
        in ONE native call. ``out`` is [N, stride] float32 or int16 (int16
        is only valid when the drained slots are i16-exact), or uint8 for
        the G.711 mu-law serving wire (samples are encoded while copying).
        Falls back to per-slot reads without the native library."""
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        if (
            out.dtype == np.uint8
            and self._lib is not None
            and hasattr(self._lib, "rss_pool_read_all_mulaw")
        ):
            rc = self._lib.rss_pool_read_all_mulaw(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.shape[1],
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if rc != 0:
                raise RuntimeError("rss_pool_read_all_mulaw: count > available")
            return
        if out.dtype == np.uint8:
            # stale native build / NumPy fallback: drain f32 then encode
            from ..ops.mulaw import encode_f32

            for i in range(self.num_slots):
                n = int(counts[i])
                if n <= 0:
                    continue
                pcm = self.read(i, n)
                out[i, int(offs[i]) : int(offs[i]) + n] = encode_f32(pcm)
            return
        if self._lib is not None and self.has_batched_drain:
            i16 = out.dtype == np.int16
            rc = self._lib.rss_pool_read_all(
                self._handle,
                None if i16 else _f32p(out),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
                if i16
                else None,
                1 if i16 else 0,
                out.shape[1],
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if rc != 0:
                raise RuntimeError("rss_pool_read_all: count > available")
            return
        for i in range(self.num_slots):
            n = int(counts[i])
            if n <= 0:
                continue
            pcm = self.read(i, n)
            out[i, int(offs[i]) : int(offs[i]) + n] = (
                pcm.astype(out.dtype) if out.dtype != np.float32 else pcm
            )
