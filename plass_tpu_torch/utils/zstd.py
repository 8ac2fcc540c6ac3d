"""ZSTD frames through the system's libzstd, bound with ctypes.

The JAX package compresses and inflates the records of a compressed DB
(data/seqdb.py) with the `zstandard` package, which the GPU machine lacks;
its libzstd is there. This module gives data/seqdb.py the two calls it
makes of that package, `ZstdCompressor(level).compress(data)` and
`ZstdDecompressor().decompress(frame, max_output_size)`, over libzstd:
ZSTD_compress writes the frame `zstandard` writes (one frame, the content
size in its header, no checksum), and a frame is inflated by
ZSTD_decompressStream, so frames whose header has no content size (the
reference's streaming DBWriter) inflate too.
"""
import ctypes
import ctypes.util
import functools


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer and ZSTD_outBuffer: {ptr, size, pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _lib():
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd not found: compressed DBs need the system's "
                      "ZSTD library (libzstd.so.1)")
    lib = ctypes.CDLL(name)
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_compressBound", size_t, [size_t]),
            ("ZSTD_compress", size_t, [ptr, size_t, ptr, size_t,
                                       ctypes.c_int]),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_createDStream", ptr, []),
            ("ZSTD_freeDStream", size_t, [ptr]),
            ("ZSTD_initDStream", size_t, [ptr]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_decompressStream", size_t,
             [ptr, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


def _check(lib, code):
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


class ZstdCompressor:
    def __init__(self, level=3):
        self.level = level

    def compress(self, data):
        lib = _lib()
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data),
                                          self.level))
        return out.raw[:n]


class ZstdDecompressor:
    def decompress(self, data, max_output_size=0):
        """The frame's content; more than max_output_size bytes (when it is
        not 0) is an error."""
        lib = _lib()
        stream = lib.ZSTD_createDStream()
        if not stream:
            raise MemoryError("zstd: no decompression stream")
        try:
            _check(lib, lib.ZSTD_initDStream(stream))
            src = ctypes.create_string_buffer(data, len(data))
            inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
            chunk = lib.ZSTD_DStreamOutSize()
            dst = ctypes.create_string_buffer(chunk)
            parts, total = [], 0
            while True:
                outb = _Buffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
                left = _check(lib, lib.ZSTD_decompressStream(
                    stream, ctypes.byref(outb), ctypes.byref(inb)))
                parts.append(dst.raw[:outb.pos])
                total += outb.pos
                if max_output_size and total > max_output_size:
                    raise ValueError("zstd: the frame inflates beyond "
                                     f"{max_output_size} bytes")
                if left == 0:
                    return b"".join(parts)
                if inb.pos == inb.size and outb.pos < chunk:
                    raise ValueError("zstd: the frame is truncated")
        finally:
            lib.ZSTD_freeDStream(stream)
