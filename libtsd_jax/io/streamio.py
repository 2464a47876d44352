"""Host-side streaming data engine: ring-buffer re-blocker and SDR IQ
format converters, backed by the native C++ library (native/streamio.cc)
with a transparent numpy fallback.

Parity: the reference's host runtime around the DSP kernels —
``tampon_création`` re-blocking (core/src/tsd.cc:303-386) and its WAV
ingest loops (core/src/wav.cc).  The converters handle the standard SDR
capture wire formats (cs16 / cu8 interleaved I/Q).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Callable, Optional

import numpy as np

__all__ = ["native_available", "RingBuffer", "Rebuffer",
           "IqFileReader",
           "cs16_to_cf32", "cu8_to_cf32", "deinterleave", "interleave"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_HERE, "..", "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libstreamio.so")
_lib: Optional[ctypes.CDLL] = None


def _build_native() -> bool:
    src = os.path.join(_NATIVE_DIR, "streamio.cc")
    if not os.path.exists(src):
        return False
    try:
        # compile to a process-unique temp path and rename into place
        # (atomic on POSIX): two processes importing concurrently must
        # never load a partially written .so
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             src, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        return False


def _stale() -> bool:
    src = os.path.join(_NATIVE_DIR, "streamio.cc")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
    except OSError:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO_PATH) or _stale()) and not _build_native():
        if not os.path.exists(_SO_PATH):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_available.restype = ctypes.c_int64
    lib.rb_available.argtypes = [ctypes.c_void_p]
    lib.rb_push.restype = ctypes.c_int64
    lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.rb_pop_block.restype = ctypes.c_int
    lib.rb_pop_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64]
    # full argtypes: without them ctypes passes the int64_t length as a
    # default C int, silently truncating for arrays >= 2^31 elements
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, nargs in [("cs16_to_cf32", 2), ("cu8_to_cf32", 2),
                        ("cf32_deinterleave", 3), ("cf32_interleave", 3),
                        ("s16_to_f32", 2), ("f32_to_s16", 2)]:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp] * nargs + [i64]
    lib.iq_open.restype = ctypes.c_void_p
    lib.iq_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.iq_next.restype = ctypes.c_int64
    lib.iq_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.iq_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _load_guarded():
    """_load with a stale-.so guard: a present-but-outdated
    libstreamio.so missing a newer symbol must degrade to the numpy
    fallback, not crash every caller with AttributeError."""
    global _lib
    try:
        return _load()
    except AttributeError:
        _lib = None
        return None


def native_available() -> bool:
    return _load_guarded() is not None


class RingBuffer:
    """Fixed-capacity sample ring buffer (native-backed when available).

    channels=2 stores complex as interleaved I/Q float32.
    """

    def __init__(self, capacity: int, complex_iq: bool = True):
        self.capacity = capacity
        self.channels = 2 if complex_iq else 1
        self._lib = _load_guarded()
        if self._lib is not None:
            self._h = self._lib.rb_create(capacity, self.channels)
            if not self._h:
                raise MemoryError(
                    f"RingBuffer: cannot allocate {capacity} samples x "
                    f"{self.channels} channels")
        else:
            self._buf = np.zeros((0, self.channels), np.float32)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and \
                getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    @property
    def available(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_available(self._h))
        return len(self._buf)

    def push(self, x: np.ndarray) -> int:
        """Push samples (complex64 array or float32); returns accepted.

        The input domain must match the ring's configuration: a real
        array into a complex_iq ring (or complex into a real one) used
        to be silently re-paired into bogus I/Q samples."""
        if np.iscomplexobj(x):
            if self.channels != 2:
                raise ValueError(
                    "complex samples pushed into a REAL ring buffer "
                    "(construct with complex_iq=True, or push floats)")
            flat = np.empty((len(x), 2), np.float32)
            flat[:, 0] = x.real
            flat[:, 1] = x.imag
        else:
            xf = np.asarray(x, np.float32)
            if self.channels == 2 and xf.ndim == 1:
                raise ValueError(
                    "real 1-D samples pushed into a complex_iq ring "
                    "buffer — consecutive floats would be silently "
                    "paired into bogus I/Q (pass complex64, an (n, 2) "
                    "array, or construct with complex_iq=False)")
            flat = xf.reshape(-1, self.channels)
        if self._lib is not None:
            flat = np.ascontiguousarray(flat)
            return int(self._lib.rb_push(
                self._h, flat.ctypes.data_as(ctypes.c_void_p), len(flat)))
        space = self.capacity - len(self._buf)
        acc = flat[:space]
        self._buf = np.concatenate([self._buf, acc])
        return len(acc)

    def snapshot(self) -> np.ndarray:
        """Non-destructively read the buffered residue in order (complex64
        when complex_iq, else float32) — used by mid-stream checkpointing
        (the samples are popped and immediately pushed back)."""
        n = self.available
        if n == 0:
            return np.zeros(
                0, np.complex64 if self.channels == 2 else np.float32)
        out = self.pop_block(n)
        acc = self.push(out)
        assert acc == n, (acc, n)
        return out

    def pop_block(self, n: int) -> Optional[np.ndarray]:
        """Pop exactly n samples or None (parity: tampon fixed-N blocks)."""
        if self._lib is not None:
            out = np.empty((n, self.channels), np.float32)
            ok = self._lib.rb_pop_block(
                self._h, out.ctypes.data_as(ctypes.c_void_p), n)
            if not ok:
                return None
        else:
            if len(self._buf) < n:
                return None
            out = self._buf[:n]
            self._buf = self._buf[n:]
        if self.channels == 2:
            return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)
        return out[:, 0].copy()


class Rebuffer:
    """Arbitrary-size pushes in -> fixed-N-block callback out (parity:
    tampon_création, core/src/tsd.cc:303-386)."""

    def __init__(self, N: int, callback: Callable[[np.ndarray], None],
                 complex_iq: bool = True, capacity: Optional[int] = None):
        self.N = N
        self.callback = callback
        self.rb = RingBuffer(capacity or max(8 * N, 1 << 16), complex_iq)

    def push(self, x: np.ndarray):
        # loop until every sample is accepted — pop_block frees space
        # between partial pushes, so a chunk larger than the remaining
        # ring space is NOT silently truncated
        x = np.asarray(x)
        off = 0
        cap = self.rb.capacity
        while off < len(x):
            # cap the slice at ring capacity: RingBuffer.push converts
            # its whole argument before storing, so feeding the full
            # remaining tail each iteration would be O(n^2/capacity)
            acc = self.rb.push(x[off: off + cap])
            off += acc
            drained = False
            while True:
                blk = self.rb.pop_block(self.N)
                if blk is None:
                    break
                drained = True
                self.callback(blk)
            if acc == 0 and not drained:
                raise RuntimeError(
                    f"Rebuffer stalled: {len(x) - off} samples don't fit "
                    f"(capacity {self.rb.capacity}, N={self.N})")

    def snapshot(self) -> np.ndarray:
        """The < N samples awaiting the next full block (non-destructive)."""
        return self.rb.snapshot()


def cs16_to_cf32(raw: np.ndarray) -> np.ndarray:
    """Interleaved int16 I/Q -> complex64 in [-1,1).  Accepts a flat
    interleaved array or the (n_iq, 2) blocks IqFileReader emits (C-order
    flattening of either IS the interleaved stream)."""
    raw = np.ascontiguousarray(raw, np.int16).reshape(-1)
    n_iq = raw.size // 2
    lib = _load_guarded()
    if lib is not None:
        out = np.empty(2 * n_iq, np.float32)
        lib.cs16_to_cf32(raw.ctypes.data_as(ctypes.c_void_p),
                         out.ctypes.data_as(ctypes.c_void_p), n_iq)
        return out.view(np.complex64)
    f = raw[: 2 * n_iq].astype(np.float32) / 32768.0
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def cu8_to_cf32(raw: np.ndarray) -> np.ndarray:
    """Interleaved uint8 (RTL-SDR) I/Q -> complex64.  Accepts a flat
    interleaved array or (n_iq, 2) IqFileReader blocks."""
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    n_iq = raw.size // 2
    lib = _load_guarded()
    if lib is not None:
        out = np.empty(2 * n_iq, np.float32)
        lib.cu8_to_cf32(raw.ctypes.data_as(ctypes.c_void_p),
                        out.ctypes.data_as(ctypes.c_void_p), n_iq)
        return out.view(np.complex64)
    f = (raw[: 2 * n_iq].astype(np.float32) - 127.5) / 127.5
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def deinterleave(x: np.ndarray) -> np.ndarray:
    """complex64 -> (2, n) float32 re/im planes (the device transfer
    format — see config.to_ri)."""
    x = np.ascontiguousarray(x, np.complex64)
    n = len(x)
    lib = _load_guarded()
    out = np.empty((2, n), np.float32)
    if lib is not None:
        lib.cf32_deinterleave(x.ctypes.data_as(ctypes.c_void_p),
                              out[0].ctypes.data_as(ctypes.c_void_p),
                              out[1].ctypes.data_as(ctypes.c_void_p), n)
    else:
        out[0] = x.real
        out[1] = x.imag
    return out


def interleave(planes: np.ndarray) -> np.ndarray:
    """(2, n) float32 -> complex64."""
    planes = np.ascontiguousarray(planes, np.float32)
    n = planes.shape[1]
    lib = _load_guarded()
    if lib is not None:
        out = np.empty(2 * n, np.float32)
        lib.cf32_interleave(planes[0].ctypes.data_as(ctypes.c_void_p),
                            planes[1].ctypes.data_as(ctypes.c_void_p),
                            out.ctypes.data_as(ctypes.c_void_p), n)
        return out.view(np.complex64)
    return (planes[0] + 1j * planes[1]).astype(np.complex64)


class IqFileReader:
    """Prefetching block reader for raw SDR capture files — the
    framework's data loader (native background-thread double buffering;
    pure-python fallback reads synchronously).

    Reads fixed-size blocks of RAW dtype: int8 ("cs8"), int16 ("cs16"),
    uint8 ("cu8"), or float32 ("cf32"), interleaved I/Q — integers stay
    integer so they can feed the metric chain's int8/int16 ingest
    directly (ops/chain.fir_periodogram4096 takes any real dtype).  The
    background thread keeps ``nbuf`` blocks in flight, so disk IO overlaps
    device compute.  No reference counterpart: core/src/wav.cc reads
    synchronously on the caller's thread.

    Usage::
        with IqFileReader(path, "cs16", block_iq=65536) as rd:
            for blk in rd:              # (block_iq, 2) int16 I/Q
                ...
    """

    _DTYPES = {"cs8": np.int8, "cs16": np.int16, "cu8": np.uint8,
               "cf32": np.float32}

    def __init__(self, path: str, fmt: str = "cs16",
                 block_iq: int = 1 << 16, nbuf: int = 4):
        assert fmt in self._DTYPES, fmt
        self.dtype = np.dtype(self._DTYPES[fmt])
        self.block_iq = block_iq
        self.block_bytes = block_iq * 2 * self.dtype.itemsize
        self._lib = _load_guarded()
        self._h = None
        self._f = None
        if self._lib is not None:
            self._h = self._lib.iq_open(path.encode(), self.block_bytes,
                                        int(nbuf))
        if self._h is None:
            self._lib = None
            self._f = open(path, "rb")

    def next_block(self) -> Optional[np.ndarray]:
        """Next block as (n_iq, 2) raw-dtype array; None at EOF.  The
        final partial block is returned truncated.  Raises OSError if the
        stream ended on a read ERROR rather than EOF."""
        if self._h is None and self._f is None:
            raise ValueError("IqFileReader is closed")
        buf = np.empty(self.block_bytes, np.uint8)
        if self._lib is not None:
            got = int(self._lib.iq_next(
                self._h, buf.ctypes.data_as(ctypes.c_void_p)))
            if got < 0:
                raise OSError("IqFileReader: read error (truncated "
                              "stream is NOT a clean EOF)")
        else:
            raw = self._f.read(self.block_bytes)
            got = len(raw)
            buf[:got] = np.frombuffer(raw, np.uint8)
        if got == 0:
            return None
        got -= got % (2 * self.dtype.itemsize)
        if got == 0:
            # the file tail held only a partial I/Q pair: that's EOF,
            # not an empty block (consumers use None as the sentinel
            # and assume returned blocks are non-empty)
            return None
        return buf[:got].view(self.dtype).reshape(-1, 2)

    def __iter__(self):
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk

    def close(self):
        if self._lib is not None and self._h:
            self._lib.iq_close(self._h)
            self._h = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
