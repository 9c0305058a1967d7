"""ctypes loader for the native oracle library.

Compiles ``oracle.cpp`` at first use with the system C++ compiler into
``liboracle-<hash>.so`` next to the source, where ``<hash>`` is
``sha256(oracle.cpp)[:16]``: a binary built from other source never has the
name the loader looks for, so a stale library cannot be loaded. The same
hash is baked into the binary (``oracle_source_hash``) and checked after
loading.

Several processes may import this module at once (pytest-xdist workers).
The build runs under an exclusive ``fcntl`` lock, writes a temporary file
in this directory and renames it into place with ``os.replace``, so no
process ever maps a half-written library and only one compiles.

Failure surface: ``available()`` is False only when something is genuinely
wrong; ``build_error()`` then says *what* (missing compiler vs compile
error with the compiler's stderr) so tests can fail loudly on breakage
instead of skipping.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cpp")
_LOCK = os.path.join(_DIR, ".build.lock")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_lib = None
_tried = False
_build_error: str | None = None


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def library_path() -> str:
    """Where the library built from the current ``oracle.cpp`` lives."""
    return os.path.join(_DIR, f"liboracle-{_source_hash()}.so")


def _build(path: str) -> None:
    """Compile ``oracle.cpp`` to ``path`` unless it is already there.

    Raises ``FileNotFoundError`` without a compiler and
    ``subprocess.CalledProcessError`` when compilation fails."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise FileNotFoundError(f"no C++ compiler ({cxx}) on PATH")
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built while this process waited
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                [cxx, *_CXXFLAGS,
                 f'-DORACLE_SOURCE_HASH="{_source_hash()}"',
                 "-o", tmp, _SRC],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _lib_hash(lib) -> str:
    fn = lib.oracle_source_hash
    fn.restype = ctypes.c_char_p
    return fn().decode()


def _load():
    global _lib, _tried, _build_error
    if _tried:
        return _lib
    _tried = True

    path = library_path()
    try:
        _build(path)
        lib = ctypes.CDLL(path)
    except FileNotFoundError as e:
        _build_error = str(e)
        return None
    except subprocess.CalledProcessError as e:
        _build_error = f"native build failed:\n{e.stderr or e.stdout}"
        return None
    except OSError as e:
        _build_error = f"native library unavailable: {e}"
        return None
    if _lib_hash(lib) != _source_hash():
        _build_error = "loaded library reports a stale source hash"
        return None

    lib.oracle_riemersma_dither.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.oracle_nn_map.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.oracle_mbd_scan.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
    ]
    lib.oracle_hilbert_d.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
    ]
    # LUT gathers: table dtype varies, output is ALWAYS int32 (the public
    # palette-map dtype; the widen is fused into the C gather)
    for name, ct in (
        ("oracle_lut_map_u8", ctypes.c_uint8),
        ("oracle_lut_map_u16", ctypes.c_uint16),
        ("oracle_lut_map_i32", ctypes.c_int32),
    ):
        getattr(lib, name).argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ct), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
    lib.oracle_rle_decode_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
    ]
    lib.oracle_rle_decode_u8_v2.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.oracle_rle_decode_u16_v2.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
    ]
    lib.oracle_pack_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
    ]
    for name, ct in (
        ("oracle_lut_map_codes_u8", ctypes.c_uint8),
        ("oracle_lut_map_codes_u16", ctypes.c_uint16),
        ("oracle_lut_map_codes_i32", ctypes.c_int32),
    ):
        getattr(lib, name).argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
            ctypes.POINTER(ct), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native library is unavailable (None when it loaded fine)."""
    _load()
    return None if _lib is not None else (_build_error or "unknown")


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _require():
    """_load() or a self-explaining failure (the lut_* wrappers return
    None by contract; the oracle entry points raise instead of
    dereferencing None with an opaque AttributeError — r5 review)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_build_error}")
    return lib


def riemersma_dither(image, width, height, palette, channel_weights):
    """Exact serial reference-semantics dither. image: (h*w, 3) f64 linear
    Rec2020; returns int32 (h*w) palette map."""
    lib = _require()
    image = np.ascontiguousarray(image, np.float64)
    palette = np.ascontiguousarray(palette, np.float64)
    cw = np.ascontiguousarray(channel_weights, np.float64)
    out = np.zeros(width * height, np.int32)
    lib.oracle_riemersma_dither(
        _ptr(image, ctypes.c_double), width, height,
        _ptr(palette, ctypes.c_double), len(palette),
        _ptr(cw, ctypes.c_double), _ptr(out, ctypes.c_int32),
    )
    return out


def nn_map(colors, palette):
    lib = _require()
    colors = np.ascontiguousarray(colors, np.float64)
    palette = np.ascontiguousarray(palette, np.float64)
    out = np.zeros(len(colors), np.int32)
    lib.oracle_nn_map(
        _ptr(colors, ctypes.c_double), len(colors),
        _ptr(palette, ctypes.c_double), len(palette),
        _ptr(out, ctypes.c_int32),
    )
    return out


def mbd(img, iters=3):
    """Full MBD transform with the reference's alternating scans."""
    lib = _require()
    img = np.ascontiguousarray(img, np.float32)
    rows, cols = img.shape
    l = img.copy()
    u = img.copy()
    d = np.full((rows, cols), np.inf, np.float32)
    d[0, :] = d[-1, :] = d[:, 0] = d[:, -1] = 0
    for it in range(iters):
        inverse = 0 if it % 2 == 1 else 1
        lib.oracle_mbd_scan(
            _ptr(img, ctypes.c_float), _ptr(l, ctypes.c_float),
            _ptr(u, ctypes.c_float), _ptr(d, ctypes.c_float),
            rows, cols, inverse,
        )
    return d


LUT_SIZE = 1 << 24
LUT_PAD = 4  # AVX-512 gather tail window (see oracle.cpp)


def lut_map_u8(colors_u8, lut, nthreads: int = 0):
    """Fused 24-bit pack + LUT gather + int32 widen:
    out[i] = int32(lut[r<<16 | g<<8 | b]).

    ``colors_u8``: (N, 3) uint8; ``lut``: (2^24,) uint8/uint16/int32, or an
    ALREADY-PADDED (2^24 + 4,) table (e.g. from :func:`rle_decode_u8`) —
    the padded form skips the 16.7 MB defensive tail-pad copy.
    Returns an (N,) int32 array (the public palette-map dtype — the widen
    is fused into the gather), or None when the native library is
    unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    fns = {
        np.dtype(np.uint8): (lib.oracle_lut_map_u8, ctypes.c_uint8),
        np.dtype(np.uint16): (lib.oracle_lut_map_u16, ctypes.c_uint16),
        np.dtype(np.int32): (lib.oracle_lut_map_i32, ctypes.c_int32),
    }
    if lut.dtype not in fns:
        return None
    fn, ct = fns[lut.dtype]
    colors_u8 = np.ascontiguousarray(colors_u8, np.uint8)
    lut = np.ascontiguousarray(lut)
    if lut.shape[0] == LUT_SIZE + LUT_PAD:
        lut_padded = lut
    else:
        # The AVX-512 path gathers 4-byte windows at byte offsets into the
        # u8/u16 table, so the last codes read up to 3 bytes past the end —
        # give the table a 4-element zero tail.
        lut_padded = np.zeros(lut.shape[0] + LUT_PAD, lut.dtype)
        lut_padded[:lut.shape[0]] = lut
    n = len(colors_u8)
    out = np.empty((n,), np.int32)
    if not nthreads:
        # latency-bound gather: oversubscribing the cores hides table
        # misses (r5 A/B on the 2-vCPU host: 3x threads beat 2x by ~8%)
        nthreads = min(12, 3 * (os.cpu_count() or 1))
    fn(_ptr(colors_u8, ctypes.c_uint8), n, _ptr(lut_padded, ct),
       _ptr(out, ctypes.c_int32), nthreads)
    return out


def pack_codes(colors_u8, nthreads: int = 0):
    """(N, 3) uint8 -> (N,) uint32 24-bit codes (r<<16|g<<8|b), threaded.

    The image-only half of :func:`lut_map_u8`, split out so the pipeline
    can run it in a background thread while the device builds the LUT.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    colors_u8 = np.ascontiguousarray(colors_u8, np.uint8)
    n = len(colors_u8)
    out = np.empty((n,), np.uint32)
    if not nthreads:
        nthreads = min(8, os.cpu_count() or 1)
    lib.oracle_pack_codes(
        _ptr(colors_u8, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint32),
        nthreads,
    )
    return out


def lut_map_codes(codes, lut, nthreads: int = 0):
    """Gather-only half of :func:`lut_map_u8` over precomputed 24-bit codes:
    out[i] = int32(lut[codes[i]]). Same padded-table contract; returns None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    fns = {
        np.dtype(np.uint8): (lib.oracle_lut_map_codes_u8, ctypes.c_uint8),
        np.dtype(np.uint16): (lib.oracle_lut_map_codes_u16, ctypes.c_uint16),
        np.dtype(np.int32): (lib.oracle_lut_map_codes_i32, ctypes.c_int32),
    }
    if lut.dtype not in fns:
        return None
    fn, ct = fns[lut.dtype]
    codes = np.ascontiguousarray(codes, np.uint32)
    lut = np.ascontiguousarray(lut)
    if lut.shape[0] == LUT_SIZE + LUT_PAD:
        lut_padded = lut
    else:
        lut_padded = np.zeros(lut.shape[0] + LUT_PAD, lut.dtype)
        lut_padded[:lut.shape[0]] = lut
    n = len(codes)
    out = np.empty((n,), np.int32)
    if not nthreads:
        # latency-bound gather: oversubscribing the cores hides table
        # misses (r5 A/B on the 2-vCPU host: 3x threads beat 2x by ~8%)
        nthreads = min(12, 3 * (os.cpu_count() or 1))
    fn(_ptr(codes, ctypes.c_uint32), n, _ptr(lut_padded, ct),
       _ptr(out, ctypes.c_int32), nthreads)
    return out


def rle_decode_u8(packed, table_size: int = LUT_SIZE):
    """Decode the LUT RLE wire format ((pos << 8) | value words, ascending
    positions) into a PADDED (table_size + 4,) uint8 table, or None when
    the native library is unavailable. The pad makes the result directly
    usable by :func:`lut_map_u8` without a copy."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint32)
    out = np.zeros(table_size + LUT_PAD, np.uint8)
    lib.oracle_rle_decode_u8(
        _ptr(packed, ctypes.c_uint32), len(packed),
        _ptr(out, ctypes.c_uint8), table_size,
        min(4, os.cpu_count() or 1),
    )
    return out


def rle_decode_u8_v2(words, table_size: int = LUT_SIZE):
    """Decode the delta-u16 RLE v2 wire format into a PADDED
    (table_size + 4,) uint8 table, or None when the native library is
    unavailable (caller uses the numpy np.repeat fallback)."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, np.uint16)
    out = np.zeros(table_size + LUT_PAD, np.uint8)
    lib.oracle_rle_decode_u8_v2(
        _ptr(words, ctypes.c_uint16), len(words),
        _ptr(out, ctypes.c_uint8), table_size,
    )
    return out


def rle_decode_u16_v2(words, table_size: int = LUT_SIZE):
    """Decode the u32-word RLE v2 format into a PADDED uint16 table
    ((table_size + LUT_PAD,) — the 4-element tail keeps the AVX-512
    gather contract), or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, np.uint32)
    out = np.zeros(table_size + LUT_PAD, np.uint16)
    lib.oracle_rle_decode_u16_v2(
        _ptr(words, ctypes.c_uint32), len(words),
        _ptr(out, ctypes.c_uint16), table_size,
    )
    return out


def hilbert_d(x, y, order):
    lib = _require()
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    out = np.zeros(len(x), np.uint64)
    lib.oracle_hilbert_d(
        _ptr(x, ctypes.c_uint32), _ptr(y, ctypes.c_uint32),
        len(x), order, _ptr(out, ctypes.c_uint64),
    )
    return out
