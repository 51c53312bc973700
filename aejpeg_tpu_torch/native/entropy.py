"""ctypes bindings for the C++ entropy backend (see entropy.cpp).

deflate_parallel(data, level, threads) -> bytes: one spec-valid zlib stream
built from independently-deflated chunks (Z_FULL_FLUSH splicing).  With
threads=1 and chunk >= len it is byte-identical to zlib.compress(level).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np


def _out_buffer(size: int):
    """Uninitialized output buffer + void_p view (create_string_buffer
    zeroes its whole allocation and .raw copies all of it — at 100 MB
    bounds that costs more than the compression itself)."""
    buf = np.empty(size, np.uint8)
    return buf, buf.ctypes.data_as(ctypes.c_void_p)


_SCRATCH = threading.local()


def scratch_arena(key: str, nbytes: int) -> np.ndarray:
    """Grow-only per-thread scratch buffer (uint8, uninitialized).

    Fresh `np.empty` of a few hundred MB costs more in page faults than the
    C++ work that fills it (measured: ~60% of round 3's 'plans'/'assemble'
    stage time on a 2-core host); reusing a warm buffer makes that cost
    one-time.  Contents are VOLATILE: valid only until the same thread asks
    for the same key again — callers must copy out anything they keep."""
    store = getattr(_SCRATCH, "bufs", None)
    if store is None:
        store = _SCRATCH.bufs = {}
    buf = store.get(key)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(max(nbytes, 1 << 16), np.uint8)
        store[key] = buf
    return buf


def scratch_view(key: str, shape, dtype) -> np.ndarray:
    """Shaped view into scratch_arena (same volatility rules)."""
    dt = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64))
    buf = scratch_arena(key, n * dt.itemsize)
    return buf[:n * dt.itemsize].view(dt).reshape(shape)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libaejentropy.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

DEFAULT_CHUNK = 1 << 20  # 1 MiB chunks: ~0.1% ratio loss, good parallelism

_ISA_MARKER = _SO + ".isa"


def _host_isa_tag() -> str:
    """Stable fingerprint of the ISA features -march=native compiles for.

    The cached .so is built with -march=native; if the package directory
    is copied to a host with a different ISA (baked image, NFS checkout),
    loading the stale .so would SIGILL on the first AVX-512 instruction.
    gcc's own view of the target is the most faithful fingerprint."""
    try:
        out = subprocess.run(
            ["g++", "-march=native", "-E", "-dM", "-xc++", os.devnull],
            capture_output=True, timeout=30).stdout
        feats = sorted(line.split()[1] for line in out.decode().splitlines()
                       if "__AVX" in line or "__SSE" in line
                       or "__BMI" in line or "__FMA" in line)
        return hashlib.sha256(" ".join(feats).encode()).hexdigest()[:16]
    except Exception:
        return "unknown"


def build_native() -> bool:
    # compile to a temp file and os.replace() it: processes that already
    # mmapped the old .so keep their inode (truncating the mapped file in
    # place would SIGBUS them)
    src = os.path.join(_DIR, "entropy.cpp")
    tmp = _SO + f".build{os.getpid()}"
    # -march=native: the library is built at import time on the host it
    # runs on, so tuning for the local ISA is always safe and measurably
    # faster (AVX-512 on this harness); fall back to baseline if the
    # compiler rejects it.
    for extra in (["-march=native"], []):
        cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17"] + extra
               + [src, "-o", tmp, "-lz", "-lpthread"])
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            try:
                with open(_ISA_MARKER, "w") as f:
                    f.write(_host_isa_tag() if extra else "baseline")
            except OSError:
                pass
            return True
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_DIR, "entropy.cpp")
        stale = (not os.path.exists(_SO)
                 or (os.path.exists(src)
                     and os.path.getmtime(src) > os.path.getmtime(_SO)))
        if not stale:
            # ISA check: an .so built with -march=native on another host
            # would SIGILL here; "baseline" builds run anywhere.
            try:
                with open(_ISA_MARKER) as f:
                    marker = f.read().strip()
                if marker != "baseline" and marker != _host_isa_tag():
                    stale = True
            except OSError:
                stale = True  # no marker: unknown provenance, rebuild
        if stale and not build_native() and not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.aej_deflate_parallel.restype = ctypes.c_size_t
        lib.aej_deflate_parallel.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
        lib.aej_inflate.restype = ctypes.c_size_t
        lib.aej_inflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
        lib.aej_deflate_bound.restype = ctypes.c_size_t
        lib.aej_deflate_bound.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.aej_replay_states.restype = ctypes.c_size_t
        lib.aej_replay_states.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.aej_build_plan.restype = ctypes.c_size_t
        lib.aej_build_plan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.aej_payload16.restype = ctypes.c_size_t
        lib.aej_payload16.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_size_t]
        lib.aej_layer_payload.restype = ctypes.c_size_t
        lib.aej_layer_payload.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_size_t]
        lib.aej_decode_layer.restype = ctypes.c_int64
        lib.aej_decode_layer.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.aej_decode_batch.restype = ctypes.c_int64
        lib.aej_decode_batch.argtypes = [ctypes.c_int64] + \
            [ctypes.c_void_p] * 9 + [ctypes.c_int32, ctypes.c_void_p]
        lib.aej_assemble_batch.restype = ctypes.c_int64
        lib.aej_assemble_batch.argtypes = [ctypes.c_int64] + \
            [ctypes.c_void_p] * 9 + [ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.aej_build_plans_batch.restype = ctypes.c_int64
        lib.aej_build_plans_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def deflate_parallel(data: bytes, level: int = 9,
                     threads: Optional[int] = None,
                     chunk_size: int = DEFAULT_CHUNK) -> bytes:
    """Compress to one zlib stream using the native thread pool; falls back
    to zlib.compress if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return zlib.compress(data, level=level)
    if threads is None:
        threads = os.cpu_count() or 1
    bound = lib.aej_deflate_bound(len(data), chunk_size)
    buf, out = _out_buffer(bound)
    n = lib.aej_deflate_parallel(data, len(data), out, bound, level,
                                 threads, chunk_size)
    if n == 0:
        return zlib.compress(data, level=level)
    return buf[:n].tobytes()


def inflate(data: bytes, max_out: int) -> bytes:
    lib = _load()
    if lib is None:
        return zlib.decompress(data)
    buf, out = _out_buffer(max_out)
    n = lib.aej_inflate(data, len(data), out, max_out)
    if n == 0:
        return zlib.decompress(data)
    return buf[:n].tobytes()


def replay_states(states, root_size: int):
    """Preorder stack replay of quadtree states -> (sizes, ys, xs) int32
    arrays, or None if the native library is unavailable (callers fall back
    to the Python replay)."""
    lib = _load()
    if lib is None:
        return None
    st = np.ascontiguousarray(states, dtype=np.uint8)
    n = st.size
    sizes = np.empty(n, np.int32)
    ys = np.empty(n, np.int32)
    xs = np.empty(n, np.int32)
    m = lib.aej_replay_states(st.tobytes(), n, root_size,
                              sizes.ctypes.data_as(ctypes.c_void_p),
                              ys.ctypes.data_as(ctypes.c_void_p),
                              xs.ctypes.data_as(ctypes.c_void_p))
    return sizes[:m], ys[:m], xs[:m]


def payload16(coeffs, threads: int = 1) -> Optional[bytes]:
    """Compress int16 coefficients as the zlib stream of their int32-LE
    widening (coefficient-domain sparse encoder; zlib.decompress of the
    result yields coeffs.astype('<i4').tobytes())."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(coeffs, dtype=np.int16)
    bound = lib.aej_deflate_bound(v.size * 4, 1 << 20)
    buf, out = _out_buffer(bound)
    n = lib.aej_payload16(v.ctypes.data_as(ctypes.c_void_p), v.size,
                          threads, out, bound)
    if n == 0 and v.size:
        return None
    return buf[:n].tobytes()


def layer_payload(leaf_sizes, leaf_y, leaf_x, h: int, w: int, pw: int,
                  table_ptrs, slow_ptrs, level: int, threads: int = 1):
    """Assemble one layer's preorder coefficient stream from dense
    zigzag-int16 tables (see entropy.cpp aej_layer_payload) and deflate it.
    `table_ptrs`/`slow_ptrs` are (ctypes.c_void_p * 8) arrays indexed by
    log2(size).  Returns the compressed bytes, or None when the native
    library is unavailable or the call fails."""
    lib = _load()
    if lib is None:
        return None
    sizes = np.ascontiguousarray(leaf_sizes, np.int32)
    ys = np.ascontiguousarray(leaf_y, np.int32)
    xs = np.ascontiguousarray(leaf_x, np.int32)
    total = int(np.sum(sizes.astype(np.int64) ** 2))
    bound = lib.aej_deflate_bound(total * 4, 1 << 20)
    buf, out = _out_buffer(bound)
    n = lib.aej_layer_payload(
        sizes.ctypes.data_as(ctypes.c_void_p),
        ys.ctypes.data_as(ctypes.c_void_p),
        xs.ctypes.data_as(ctypes.c_void_p),
        len(sizes), h, w, pw,
        ctypes.cast(table_ptrs, ctypes.c_void_p),
        ctypes.cast(slow_ptrs, ctypes.c_void_p),
        level, threads, out, bound)
    if n == 0 and total > 0:
        return None
    return buf[:n].tobytes()


def decode_layer(states_bytes: bytes, bits_len: int, root_size: int,
                 comp: bytes, pw: int, ph: int, table_ptrs,
                 mask_ptrs=None):
    """Replay a layer's state stream, decode its coefficient stream (custom
    sparse inflater with zlib fallback) and scatter zigzag-int16 rows into
    dense tables (see entropy.cpp aej_decode_layer).  Leaf geometry is
    bounds-validated against the (ph, pw) padded plane.  With `mask_ptrs`
    (8 per-size uint8 mask-plane pointers), each leaf's grid cell is marked
    1 and the tables may be uninitialized scratch (non-leaf rows are gated
    out on device); without it the tables must be pre-zeroed.
    Returns the leaf count, or None when unavailable / malformed."""
    lib = _load()
    if lib is None:
        return None
    n = lib.aej_decode_layer(states_bytes, bits_len, root_size, comp,
                             len(comp), pw, ph,
                             ctypes.cast(table_ptrs, ctypes.c_void_p),
                             ctypes.cast(mask_ptrs, ctypes.c_void_p)
                             if mask_ptrs is not None else None)
    return None if n < 0 else int(n)


def decode_batch_native(states_ptrs, bits_lens, root_sizes, comp_ptrs,
                        comp_lens, pws, phs, table_ptrs, mask_ptrs=None,
                        threads: Optional[int] = None):
    """One call decoding n (container, layer) tasks on a C++ thread pool
    (see entropy.cpp aej_decode_batch).  Pointer args are int64/int32 numpy
    arrays (table_ptrs / mask_ptrs: (n, 8) uint64; mask_ptrs optional, see
    decode_layer).  Returns the per-task leaf counts (-1 = malformed), or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(bits_lens)
    out = np.empty(n, np.int64)
    if threads is None:
        threads = os.cpu_count() or 1
    lib.aej_decode_batch(
        n, states_ptrs.ctypes.data, bits_lens.ctypes.data,
        root_sizes.ctypes.data, comp_ptrs.ctypes.data,
        comp_lens.ctypes.data, pws.ctypes.data, phs.ctypes.data,
        table_ptrs.ctypes.data,
        mask_ptrs.ctypes.data if mask_ptrs is not None else None,
        threads, out.ctypes.data)
    return out


def assemble_batch_native(leaf_size_ptrs, leaf_y_ptrs, leaf_x_ptrs,
                          n_leaves, hs, ws, pws, table_ptrs, slow_ptrs,
                          level: int, arena, arena_offs,
                          threads: Optional[int] = None):
    """One call assembling + entropy-coding n (image, layer) payloads on a
    C++ thread pool (see entropy.cpp aej_assemble_batch).  Returns the
    per-task payload sizes (-1 = failure), or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(n_leaves)
    out = np.empty(n, np.int64)
    if threads is None:
        threads = os.cpu_count() or 1
    failed = lib.aej_assemble_batch(
        n, leaf_size_ptrs.ctypes.data, leaf_y_ptrs.ctypes.data,
        leaf_x_ptrs.ctypes.data, n_leaves.ctypes.data, hs.ctypes.data,
        ws.ctypes.data, pws.ctypes.data, table_ptrs.ctypes.data,
        slow_ptrs.ctypes.data, level, threads, arena.ctypes.data,
        arena_offs.ctypes.data, out.ctypes.data)
    if failed:
        return None
    return out


def build_plans_batch(packed_bits: np.ndarray, roots, hs, ws, bit_offs,
                      k_lo: int, k_hi: int, max_size: int, min_size: int,
                      threads: Optional[int] = None):
    """All B x n_layers quadtree plans in one call from the BIT-PACKED
    pooled levels (see entropy.cpp aej_build_plans_batch).  Returns
    (states_packed (T, sp_stride) u8, bits_len (T,) i64, sizes/ys/xs
    (T, leaf_stride) i32 arenas, n_leaves (T,) i64, totals (T,) i64) with
    T = B * n_layers, or None when unavailable or over capacity.

    The five large outputs are views into per-thread scratch arenas —
    VOLATILE until this thread's next call; callers must copy what they
    keep (batch_encode._build_plans compacts them into exact-size
    per-call arrays)."""
    lib = _load()
    if lib is None:
        return None
    b = packed_bits.shape[0]
    n_layers = len(roots)
    kmin = max(int(min_size).bit_length() - 1, 0)
    g_min = max(max(int(r) for r in roots) >> kmin, 1)
    cap_l = (4 * g_min * g_min) // 3 + 64
    sp_stride = (cap_l + 3) // 4
    t = b * n_layers
    packed_bits = np.ascontiguousarray(packed_bits, np.uint8)
    states = scratch_view("plan_states", (t, sp_stride), np.uint8)
    sizes = scratch_view("plan_sizes", (t, cap_l), np.int32)
    ys = scratch_view("plan_ys", (t, cap_l), np.int32)
    xs = scratch_view("plan_xs", (t, cap_l), np.int32)
    bits_len = np.empty(t, np.int64)
    n_leaves = np.empty(t, np.int64)
    totals = np.empty(t, np.int64)
    roots_a = np.ascontiguousarray(roots, np.int32)
    hs_a = np.ascontiguousarray(hs, np.int32)
    ws_a = np.ascontiguousarray(ws, np.int32)
    offs_a = np.ascontiguousarray(bit_offs, np.int64)
    if threads is None:
        threads = os.cpu_count() or 1
    failed = lib.aej_build_plans_batch(
        packed_bits.ctypes.data, packed_bits.strides[0], b, n_layers,
        roots_a.ctypes.data, hs_a.ctypes.data, ws_a.ctypes.data,
        offs_a.ctypes.data, k_hi - k_lo + 1, k_lo, max_size, min_size,
        states.ctypes.data, sp_stride, bits_len.ctypes.data,
        sizes.ctypes.data, ys.ctypes.data, xs.ctypes.data, cap_l,
        n_leaves.ctypes.data, totals.ctypes.data, threads)
    if failed:
        return None
    return states, bits_len, sizes, ys, xs, n_leaves, totals


def build_plan(levels_concat, level_offsets, k_lo: int, k_hi: int,
               root_size: int, h: int, w: int, max_size: int,
               min_size: int):
    """Native preorder quadtree plan from pooled has-edge masks.  Returns
    (states, sizes, ys, xs) int arrays or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    lv = np.ascontiguousarray(levels_concat, dtype=np.uint8)
    offs = np.ascontiguousarray(level_offsets, dtype=np.int64)
    # visited nodes <= 4/3 * (root/min)^2 + depth slack
    kmin = max(min_size.bit_length() - 1, 0)
    g_min = max(root_size >> kmin, 1)
    cap = (4 * g_min * g_min) // 3 + 64
    states = np.empty(cap, np.uint8)
    sizes = np.empty(cap, np.int32)
    ys = np.empty(cap, np.int32)
    xs = np.empty(cap, np.int32)
    n_states = ctypes.c_size_t(0)
    nl = lib.aej_build_plan(
        lv.ctypes.data_as(ctypes.c_void_p),
        offs.ctypes.data_as(ctypes.c_void_p),
        k_lo, k_hi, root_size, h, w, max_size, min_size,
        states.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        ys.ctypes.data_as(ctypes.c_void_p),
        xs.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(n_states))
    return (states[:n_states.value].copy(), sizes[:nl].copy(),
            ys[:nl].copy(), xs[:nl].copy())
