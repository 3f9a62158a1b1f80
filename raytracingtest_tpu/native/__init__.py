"""ctypes bindings to the native runtime library (csrc/libsvo.so).

Native components (role parity with the reference's native pieces —
FastNoiseSIMD host noise and the CUDA Trace.cu kernel, SURVEY.md §2.7/2.3):

  * rtt_noise3 / rtt_fbm3 — threaded batch gradient noise, bit-identical to
    utils/noise.py (used by the host-side streaming builder)
  * rtt_trace — threaded batch ESVO traversal, semantics of
    reference/traverse.py (fast golden oracle + CPU serving fallback)
  * rtt_morton_* — 64-bit Morton batch encode/decode

The library is a build product, never checked in: it is built from the
csrc/ sources on first use, and again whenever a source is newer than it
(gcc only, no deps); everything degrades gracefully to the pure numpy
implementations when it cannot be built.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import tempfile
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_SO = os.path.join(_CSRC, "libsvo.so")
_lib = None
_lock = threading.Lock()


def stale() -> bool:
    """True when the library is missing or older than any csrc/*.cpp."""
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(os.path.getmtime(src) > built
               for src in glob.glob(os.path.join(_CSRC, "*.cpp")))


def build(quiet: bool = True) -> bool:
    """Compile the native library. Returns True on success.

    The compiler writes a uniquely named file in csrc/ that is then renamed
    over the library in one step, so processes that build at the same time
    (test workers importing this module together) never load a half-written
    file."""
    fd, tmp = tempfile.mkstemp(prefix="libsvo-", suffix=".tmp", dir=_CSRC)
    os.close(fd)
    name = os.path.basename(tmp)
    try:
        # -B: the empty placeholder is newer than the sources, so force make
        subprocess.run(
            ["make", "-B", "-C", _CSRC, f"SO={name}", name],
            check=True,
            capture_output=quiet,
        )
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(auto_build: bool = True):
    """Load (building if needed) the native library, or None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if auto_build and stale():
            if not build():
                return None
        if not os.path.exists(_SO):
            return None
        lib = ctypes.CDLL(_SO)
        i64 = ctypes.c_int64
        u32 = ctypes.c_uint32
        i32 = ctypes.c_int32
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")

        lib.rtt_noise3.argtypes = [f32p, f32p, f32p, f32p, i64, u32]
        lib.rtt_fbm3.argtypes = [f32p, f32p, f32p, f32p, i64, u32,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_float]
        lib.rtt_trace.argtypes = [i32p, i32p, i32p, ctypes.c_int, f32p, f32p,
                                  ctypes.c_void_p, i64, i32p, f32p, i32p,
                                  i32p, i32p]
        lib.rtt_morton_encode64.argtypes = [u32p, u32p, u32p, u64p, i64]
        lib.rtt_morton_decode64.argtypes = [u64p, u32p, u32p, u32p, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def noise3(x, y, z, seed: int = 0):
    lib = load()
    x = np.ascontiguousarray(x, np.float32).ravel()
    y = np.ascontiguousarray(y, np.float32).ravel()
    z = np.ascontiguousarray(z, np.float32).ravel()
    out = np.empty_like(x)
    lib.rtt_noise3(x, y, z, out, x.size, np.uint32(seed))
    return out


def fbm3(x, y, z, seed: int = 0, octaves: int = 2, lacunarity: float = 2.0,
         gain: float = 0.5):
    lib = load()
    shape = np.shape(x)
    x = np.ascontiguousarray(x, np.float32).ravel()
    y = np.ascontiguousarray(y, np.float32).ravel()
    z = np.ascontiguousarray(z, np.float32).ravel()
    out = np.empty_like(x)
    lib.rtt_fbm3(x, y, z, out, x.size, np.uint32(seed), octaves,
                 np.float32(lacunarity), np.float32(gain))
    return out.reshape(shape)


def trace(svo, origin, direction, root=None):
    """Native batch trace; returns the same tuple layout as
    ops.traverse.TraceResult."""
    from raytracingtest_tpu.ops.traverse import TraceResult

    lib = load()
    o = np.ascontiguousarray(origin, np.float32)
    d = np.ascontiguousarray(direction, np.float32)
    n = o.shape[0]
    masks = np.ascontiguousarray(svo.masks, np.int32)
    child_base = np.ascontiguousarray(svo.child_base, np.int32)
    leaf_base = np.ascontiguousarray(svo.leaf_base, np.int32)
    hit_leaf = np.empty(n, np.int32)
    hit_t = np.empty(n, np.float32)
    hit_parent = np.empty(n, np.int32)
    hit_child = np.empty(n, np.int32)
    iters = np.empty(n, np.int32)
    roots_p = None
    if root is not None:
        roots_arr = np.ascontiguousarray(
            np.broadcast_to(np.asarray(root, np.int32), (n,)))
        roots_p = roots_arr.ctypes.data_as(ctypes.c_void_p)
    lib.rtt_trace(masks, child_base, leaf_base, svo.depth, o, d, roots_p,
                  n, hit_leaf, hit_t, hit_parent, hit_child, iters)
    return TraceResult(hit_leaf, hit_t, hit_parent, hit_child, iters)


def morton_encode64(x, y, z):
    lib = load()
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    z = np.ascontiguousarray(z, np.uint32)
    out = np.empty(x.shape, np.uint64)
    lib.rtt_morton_encode64(x, y, z, out, x.size)
    return out
