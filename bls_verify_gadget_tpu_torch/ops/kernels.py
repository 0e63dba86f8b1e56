"""The port's CUDA field kernels: nvcc build, ctypes loader, and one torch
wrapper per kernel (the counterpart of the JAX package's
ops/pallas/kernels.py FieldKernels.mul/add/sub/fp2_mul/fp2_sqr).

The sources in csrc/ are compiled on first use with nvcc for sm_90a into a
shared library with a plain C interface under build/ (named by a hash of
the sources and flags, so an edited source rebuilds).  Nothing is built or
loaded when the module is imported.

Every wrapper takes int32 (..., nlimb) limb tensors that broadcast against
each other.  A tensor on the CPU goes to the kernel's plain PyTorch version
(ops/fp.py, ops/tower.py); a CUDA tensor launches the kernel on the current
stream or raises -- there is no fallback from a CUDA tensor to the plain
version.  Each launch adds one to the kernel's count in COUNTS.
"""

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("field.cuh", "field_kernels.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("mul", "add", "sub", "fp2_mul", "fp2_sqr")


class LaunchCounts:
    """Launches, elements processed and launches per element count, per
    kernel, since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.elements = dict.fromkeys(KERNELS, 0)
        self.sizes = {k: collections.Counter() for k in KERNELS}

    def record(self, name: str, n: int):
        self.launches[name] += 1
        self.elements[name] += n
        self.sizes[name][n] += 1


COUNTS = LaunchCounts()

_lib = None
_lib_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libbls_field_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/ into the shared library unless it is already built.
    The compiler's report (registers, spills) lands beside it as .log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / "field_kernels.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def _declare(lib):
    vp, i64, i32, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    lib.bls_mul.argtypes = [vp, vp, vp, i64, i32, vp, u32, vp]
    lib.bls_add.argtypes = [vp, vp, vp, i64, i32, vp, vp]
    lib.bls_sub.argtypes = [vp, vp, vp, i64, i32, vp, vp]
    lib.bls_fp2_mul.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp, u32, vp]
    lib.bls_fp2_sqr.argtypes = [vp, vp, vp, vp, i64, vp, u32, vp]
    for fn in (lib.bls_mul, lib.bls_add, lib.bls_sub, lib.bls_fp2_mul, lib.bls_fp2_sqr):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


_p_words_cache = {}


def _p_words(field):
    """Address of the modulus as a host uint32 word array (the array is
    kept alive in the cache)."""
    arr = _p_words_cache.get(field.modulus)
    if arr is None:
        arr = (ctypes.c_uint32 * len(field.p_words))(*field.p_words)
        _p_words_cache[field.modulus] = arr
    return ctypes.addressof(arr)


def _cuda_operands(field, ts):
    """Check that every operand is a CUDA int32 (..., nlimb) tensor on the
    current device; return them contiguous."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"field kernels take CPU or CUDA tensors, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands on {dev}, current device is cuda:{torch.cuda.current_device()}")
    out = []
    for t in ts:
        if t.device != dev or t.dtype != torch.int32 or t.shape[-1] != field.nlimb:
            raise ValueError(
                f"expected int32 (..., {field.nlimb}) tensors on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        out.append(t.contiguous())
    return out


def _check_rc(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _binary(name, field, a, b, plain):
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return plain(a, b)
    a, b = _cuda_operands(field, [a, b])
    out = torch.empty_like(a)
    n = a.numel() // field.nlimb
    if n:
        lib = library()
        fn = getattr(lib, f"bls_{name}")
        if name == "mul":
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field.nlimb,
                    _p_words(field), field.n0_word, _stream(a))
        else:
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field.nlimb,
                    _p_words(field), _stream(a))
        _check_rc(name, rc)
        COUNTS.record(name, n)
    return out


def mul(field, a, b):
    """Montgomery a*b*R^-1 mod m (replaces FieldKernels.mul)."""
    return _binary("mul", field, a, b, field.mul_plain)


def add(field, a, b):
    """Canonical (a + b) mod m (replaces FieldKernels.add)."""
    return _binary("add", field, a, b, field.add_plain)


def sub(field, a, b):
    """Canonical (a - b) mod m (replaces FieldKernels.sub)."""
    return _binary("sub", field, a, b, field.sub_plain)


def fp2_mul(field, a0, a1, b0, b1):
    """Karatsuba Fp2 product -> (c0, c1) (replaces FieldKernels.fp2_mul)."""
    a0, a1, b0, b1 = torch.broadcast_tensors(a0, a1, b0, b1)
    if a0.device.type == "cpu":
        from . import tower

        return tower.fp2_mul_plain(a0, a1, b0, b1)
    a0, a1, b0, b1 = _cuda_operands(field, [a0, a1, b0, b1])
    c0, c1 = torch.empty_like(a0), torch.empty_like(a0)
    n = a0.numel() // field.nlimb
    if n:
        rc = library().bls_fp2_mul(
            a0.data_ptr(), a1.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            c0.data_ptr(), c1.data_ptr(), n, _p_words(field), field.n0_word,
            _stream(a0),
        )
        _check_rc("fp2_mul", rc)
        COUNTS.record("fp2_mul", n)
    return c0, c1


def fp2_sqr(field, a0, a1):
    """Fp2 square -> (c0, c1) (replaces FieldKernels.fp2_sqr)."""
    a0, a1 = torch.broadcast_tensors(a0, a1)
    if a0.device.type == "cpu":
        from . import tower

        return tower.fp2_sqr_plain(a0, a1)
    a0, a1 = _cuda_operands(field, [a0, a1])
    c0, c1 = torch.empty_like(a0), torch.empty_like(a0)
    n = a0.numel() // field.nlimb
    if n:
        rc = library().bls_fp2_sqr(
            a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), c1.data_ptr(), n,
            _p_words(field), field.n0_word, _stream(a0),
        )
        _check_rc("fp2_sqr", rc)
        COUNTS.record("fp2_sqr", n)
    return c0, c1
