"""Host C++ kernels of the assemble, nuclassemble and guided_nuclassemble
slices, built on demand with g++ and loaded via ctypes.

The sources in this directory are this package's own copies of the JAX
package's, byte for byte: `extend.cpp` (protein greedy extender),
`nucl_extend.cpp` (nucleotide greedy extender and its protein-guided
variant), `finish.cpp` (rescore post-processing), `gather.cpp` (record
padding and gathers), `aln2nucl.cpp` (proteinaln2nucl window scoring),
`ssw.cpp` (the striped Smith-Waterman of the amino-acid aligner),
`banded.cpp` (its banded backtrace), `tantan.cpp` (the prefilter's
low-complexity masking) and `ungapped.cpp` (the ungapped-diagonal scores of
`ungapped_prefilter`), `pssm.cpp` (the PSSM, sequence weights and profile
byte codes of the profile tools) and `profilestates.cpp` (context-state
discretisation and the profile query's k-mer and alignment matrices). The
last three are built with AVX2, as in the JAX package's build: `pssm.cpp`
mirrors the reference's AVX2 reciprocal sequence-weight kernel, and
another build gives other float bits, so other profile bytes. The library
is built into the port's build directory under a name that hashes the
sources' bytes and the compile flags, so a library built from other bytes
or with other flags is never loaded.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

from .. import BUILD_DIR

SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["extend.cpp", "nucl_extend.cpp", "finish.cpp", "gather.cpp",
            "aln2nucl.cpp", "ssw.cpp", "banded.cpp", "tantan.cpp",
            "ungapped.cpp", "pssm.cpp", "profilestates.cpp"]
# sources whose results follow the AVX2 build; only they are compiled with
# -mavx2
_AVX2_SOURCES = {"ungapped.cpp", "pssm.cpp", "profilestates.cpp"}
_FLAGS = ["-O3", "-std=c++14", "-fopenmp", "-fPIC"]
_LINK_FLAGS = ["-shared", "-fopenmp"]
_LOCK = threading.Lock()
_LIB = None


def _compile_flags(src):
    return _FLAGS + (["-mavx2"] if src in _AVX2_SOURCES else [])


def library_tag(source_dir=SOURCE_DIR):
    """Hash of every source's name and bytes, its compile flags and the
    link flags: the library's name carries it."""
    h = hashlib.sha256(" ".join(_LINK_FLAGS).encode())
    for src in _SOURCES:
        with open(os.path.join(source_dir, src), "rb") as fh:
            data = fh.read()
        h.update(f"\0{src}\0{' '.join(_compile_flags(src))}\0"
                 f"{len(data)}\0".encode())
        h.update(data)
    return h.hexdigest()[:16]


def _build(so_path):
    """Compile into a temporary file and rename it into place, so that
    processes building at the same time never load a half-written file."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(so_path)) as tmp:
        objs = []
        for src in _SOURCES:
            obj = os.path.join(tmp, src + ".o")
            subprocess.run(["g++", *_compile_flags(src), "-c",
                            os.path.join(SOURCE_DIR, src), "-o", obj],
                           check=True, capture_output=True)
            objs.append(obj)
        out = os.path.join(tmp, "lib.so")
        subprocess.run(["g++", *_LINK_FLAGS, *objs, "-o", out],
                       check=True, capture_output=True)
        os.replace(out, so_path)


def lib():
    """Load (building if needed) the host kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        # the name follows the sources' bytes and the flags, so a library
        # built from anything else is never taken for this one
        so_path = os.path.join(BUILD_DIR,
                               f"libplass_host-{library_tag()}.so")
        if not os.path.exists(so_path):
            _build(so_path)
        _LIB = ctypes.CDLL(so_path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f64p = ctypes.POINTER(ctypes.c_double)
        _LIB.assemble_greedy.argtypes = [
            u8p, i64p, i32p, u32p, ctypes.c_int32,
            i64p, u32p, i32p, i32p, f64p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i16p, ctypes.c_double, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, i64p, i64p, u8p]
        _LIB.assemble_greedy.restype = ctypes.c_int
        _LIB.nucl_assemble_greedy.argtypes = [
            u8p, i64p, i32p, u32p, ctypes.c_int32,
            i64p, u32p, i32p, i32p, f64p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i16p, u8p, ctypes.c_double, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, i64p, i64p, u8p]
        _LIB.nucl_assemble_greedy.restype = ctypes.c_int
        _LIB.guided_assemble_greedy.argtypes = [
            u8p, i64p, i32p, u8p, i64p, i32p, u32p, ctypes.c_int32,
            i64p, i32p, u32p, i32p, i32p, f64p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, i16p, ctypes.c_double, ctypes.c_int64, u8p,
            u8p, ctypes.c_int64, i64p, i64p,
            u8p, ctypes.c_int64, i64p, i64p, u8p]
        _LIB.guided_assemble_greedy.restype = ctypes.c_int
        _LIB.gather_records.argtypes = [u8p, i64p, i64p, i64p,
                                        ctypes.c_int64, u8p]
        _LIB.rescore_finish.argtypes = [
            ctypes.c_int64, i64p, i32p, i32p, i32p, i32p, u8p, i64p, i32p,
            i32p, i32p, i64p, f64p, f64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, u8p, u8p]
        _LIB.aln2nucl_score.argtypes = [
            ctypes.c_int64, u8p, i64p, i32p, i32p, i32p, i32p, i32p,
            i16p, i32p, f64p]
        _LIB.ssw_byte.argtypes = [u8p, ctypes.c_int, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_uint8,
                                  ctypes.c_uint8, u8p, ctypes.c_uint8,
                                  ctypes.c_uint8, ctypes.c_int32, u8p, i32p]
        _LIB.ssw_word.argtypes = [u8p, ctypes.c_int, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_uint16,
                                  ctypes.c_uint16, u16p, ctypes.c_uint16,
                                  ctypes.c_int32, u16p, i32p]
        _LIB.banded_backtrace.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        _LIB.banded_backtrace.restype = ctypes.c_int64
        _LIB.tantan_mask.argtypes = [
            u8p, ctypes.c_int64, f64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_uint8]
        _LIB.tantan_mask.restype = ctypes.c_int64
        _LIB.ungapped_max_score.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8, u8p,
            ctypes.c_int64]
        _LIB.ungapped_max_score.restype = ctypes.c_int32
        _LIB.ungapped_all.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8, u8p,
            i64p, i64p, ctypes.c_int64, i32p]
        f32p = ctypes.POINTER(ctypes.c_float)
        _LIB.pssm_compute.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_float, ctypes.c_float, f64p, f32p,
            i8p, f32p, f32p, u8p]
        _LIB.pssm_neff_to_char.argtypes = [ctypes.c_float]
        _LIB.pssm_neff_to_char.restype = ctypes.c_uint8
        _LIB.pssm_score_mask.argtypes = [ctypes.c_float]
        _LIB.pssm_score_mask.restype = ctypes.c_uint8
        _LIB.pssm_score_unmask.argtypes = [ctypes.c_uint8]
        _LIB.pssm_score_unmask.restype = ctypes.c_float
        _LIB.pssm_neff_to_float.argtypes = [ctypes.c_uint8]
        _LIB.pssm_neff_to_float.restype = ctypes.c_float
        _LIB.pssm_scalar_prod20.argtypes = [f32p, f32p]
        _LIB.pssm_scalar_prod20.restype = ctypes.c_float
        _LIB.pssm_flog2.argtypes = [ctypes.c_float]
        _LIB.pssm_flog2.restype = ctypes.c_float
        _LIB.pssm_seq_weights.argtypes = [u8p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int64,
                                          f32p]
        _LIB.ps_fpow2.argtypes = [ctypes.c_float]
        _LIB.ps_fpow2.restype = ctypes.c_double
        _LIB.ps_score.argtypes = [f32p, f32p, f32p]
        _LIB.ps_score.restype = ctypes.c_float
        _LIB.ps_disc_scores.argtypes = [f32p, f32p, ctypes.c_int64,
                                        ctypes.c_int64, f32p]
        _LIB.ps_discretize.argtypes = [f32p, ctypes.c_int64, f32p, f32p,
                                       f32p, f32p, ctypes.c_int64,
                                       ctypes.c_int64, u8p]
        _LIB.ps_discretize_cs219.argtypes = [f32p, ctypes.c_int64, f32p,
                                             f32p, f32p, ctypes.c_int64, u8p]
        _LIB.pq_map_profile.argtypes = [f32p, f64p, ctypes.c_int64,
                                        ctypes.c_int32, i16p, u32p, i8p]
        return _LIB
