"""The port's CUDA kernels: nvcc build, ctypes loader, and one torch wrapper
per kernel (the counterpart of the JAX package's ops/pallas/kernels.py
FieldKernels.mul/add/sub/fp2_mul/fp2_sqr/fp6_mul/fp12_mul/fp12_sqr/
miller_dbl_run/miller_add/exp_x/pow_win/pt_mul_const/g2_cofactor/sswu_map2/
pt_dbl/pt_add/pt_mul_var/mul014/dbl_step/add_step/cyclo_sqr), and xmd and
lc_dot, which replace no Pallas kernel: expand_message_xmd with its
SHA-256, which XLA fuses in the JAX package (ops/sha256.py,
ops/hash_to_g2.py), and the R1CS layer's sparse Montgomery dot product of
witness columns with coefficient rows (r1cs/evaluator.py _dot_rows,
complete_witness, r1cs/witness_vm.py _eval_lcs).

The sources in csrc/ are compiled on first use with nvcc for sm_90a, one
nvcc per .cu file, all started together, and linked into one shared
library with a plain C interface under build/ (named by a hash of the
sources and flags, so an edited source rebuilds).  Nothing is built or
loaded when the module is imported.

The field wrappers take int32 (..., nlimb) limb tensors that broadcast
against each other; the others take packed (c, N, 24) tensors (an Fp2 is 2
coordinates, a Jacobian point 3 or 6, an Fp6 6, an Fp12 12,
coefficient-major) and
pack their operands into one contiguous buffer per launch, except the step
kernels (mul014, dbl_step, add_step) and pt_add, which take one pointer per
operand.  xmd takes uint8 (B, L) message bytes and int32 (B,) lengths;
lc_dot a (B, V, 24) witness, (R, W) indices and (R, W, 24) coefficients.
A tensor on the
CPU goes to the kernel's plain PyTorch version (ops/fp.py, ops/tower.py,
ops/curve.py, ops/hash_to_g2.py, ops/pairing.py, r1cs/evaluator.py); a CUDA
tensor launches the kernel on the current stream or raises -- there is no
fallback from a CUDA tensor to the plain version.  Each launch adds one to
the kernel's count in COUNTS.  The staged kernels (mul, add, sub,
fp2_mul, fp2_sqr) and lc_dot read and write whole rows as 16-byte vectors:
their wrappers refuse an operand that does not start on a 16-byte boundary.
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

from ..utils import profiling

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
UNITS = ("field_kernels.cu", "pairing_kernels.cu", "hash_kernels.cu",
         "point_kernels.cu", "xmd_kernels.cu", "r1cs_kernels.cu")  # one nvcc each
SOURCES = ("field.cuh", "tower.cuh", "group.cuh", "group_rounds.cuh", "lanes.cuh", *UNITS)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = (
    "mul", "add", "sub", "fp2_mul", "fp2_sqr", "fp6_mul",
    "fp12_mul", "fp12_sqr", "miller_dbl_run", "miller_add", "exp_x",
    "pow_win", "pt_mul_const", "g2_cofactor", "sswu_map2",
    "pt_dbl", "pt_add", "pt_mul_var",
    "mul014", "dbl_step", "add_step", "cyclo_sqr", "xmd", "lc_dot",
)
MILLER_PAIRS = (1, 2)  # pair counts of a Miller launch (csrc/pairing_kernels.cu)
SCALAR_LIMBS = 16  # raw Fr scalar limbs of pt_mul_var (csrc/point_kernels.cu)
MAX_SEGMENTS = 64  # runs of a ladder or exp_x chain (csrc/tower.cuh kMaxSegments)
MAX_DIGITS = 192  # 4-bit windows of a pow_win exponent (csrc/tower.cuh kMaxDigits)


class LaunchCounts:
    """Launches, elements processed and launches per element count (per row
    width for lc_dot), per kernel, since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.elements = dict.fromkeys(KERNELS, 0)
        self.sizes = {k: collections.Counter() for k in KERNELS}

    def record(self, name: str, n: int, size=None):
        self.launches[name] += 1
        self.elements[name] += n
        self.sizes[name][n if size is None else size] += 1


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
    """Compile csrc/ into the shared library unless it is already built:
    one nvcc per unit, all running at once, then one link.  The compilers'
    reports (registers, stack, spills) land beside it as .log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{pathlib.Path(u).stem}.o") for u in UNITS]
    logs = [o.with_suffix(".log") for o in objs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / u)]
            for o, u in zip(objs, UNITS)]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT))
        rcs = [p.wait() for p in procs]
        report = "".join(log.read_text() for log in logs)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        if not any(rcs):
            res = subprocess.run(link, capture_output=True, text=True)
            report += res.stdout + res.stderr
            rcs.append(res.returncode)
        so.with_suffix(".log").write_text(report)
        if any(rcs):
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rcs}):\n{report}")
        os.replace(tmp, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in objs + logs:
            f.unlink(missing_ok=True)
    return so


def _declare(lib, names=KERNELS):
    """Argument and result types of the entry points bls_<name> of `names`
    (all the kernels of the library; one unit's in a build of that unit)."""
    vp, i64, i32, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    argtypes = {
        "mul": [vp, vp, vp, i64, i32, vp, u32, vp],
        "add": [vp, vp, vp, i64, i32, vp, vp],
        "sub": [vp, vp, vp, i64, i32, vp, vp],
        "fp2_mul": [vp, vp, vp, vp, vp, vp, i64, vp, u32, vp],
        "fp2_sqr": [vp, vp, vp, vp, i64, vp, u32, vp],
        "fp6_mul": [vp, vp, i64, vp, u32, vp],
        "fp12_mul": [vp, vp, i64, vp, u32, vp],
        "fp12_sqr": [vp, vp, i64, vp, u32, vp],
        "miller_dbl_run": [vp, vp, vp, i64, i32, i32, vp, u32, vp],
        "miller_add": [vp, vp, vp, i64, i32, vp, u32, vp],
        "exp_x": [vp, vp, i64, vp, vp, i32, vp, u32, vp],
        "pow_win": [vp, vp, i64, i32, vp, i32, vp, u32, vp],
        "pt_mul_const": [vp, vp, i64, i32, vp, vp, i32, vp, vp, u32, vp],
        "g2_cofactor": [vp, vp, i64, vp, vp, i32, vp, vp, vp, u32, vp],
        "sswu_map2": [vp, vp, vp, i64, vp, i32, vp, i32, vp, vp, u32, vp],
        "pt_dbl": [vp, vp, i64, i32, i32, vp, u32, vp],
        "pt_add": [vp, vp, vp, i64, i32, vp, vp, u32, vp],
        "pt_mul_var": [vp, vp, vp, i64, i32, i32, vp, vp, u32, vp],
        "mul014": [vp, vp, vp, i64, vp, u32, vp],
        "dbl_step": [vp, vp, vp, i64, vp, u32, vp],
        "add_step": [vp, vp, vp, vp, i64, vp, u32, vp],
        "cyclo_sqr": [vp, vp, i64, i32, vp, u32, vp],
        "xmd": [vp, vp, i64, i32, vp, i32, i32, i32, vp, vp],
        "lc_dot": [vp, vp, vp, vp, i64, i64, i64, i32, vp, u32, vp],
        "launch_floor": [u32, i32, vp],
    }
    for name in names:
        fn = getattr(lib, f"bls_{name}")
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib, (*KERNELS, "launch_floor"))
            _lib = lib
    return _lib


_host_arrays = {}


def _host_array(ctype, values):
    """Address of a host array of `values` (cached, so it stays alive)."""
    key = (ctype, tuple(values))
    arr = _host_arrays.get(key)
    if arr is None:
        arr = (ctype * max(len(values), 1))(*values)
        _host_arrays[key] = arr
    return ctypes.addressof(arr)


def _words(field, ints):
    """Address of host ints < 2^384 as little-endian uint32 words, 12 per
    int (the kernels' by-value Fp constants)."""
    nw = field.nlimb // 2
    return _host_array(ctypes.c_uint32, [(x >> (32 * j)) & 0xFFFFFFFF for x in ints
                                         for j in range(nw)])


def _p_words(field):
    """Address of the modulus as host uint32 words."""
    return _words(field, [field.modulus])


def _mont_words(field, values):
    """Address of host ints in Montgomery form as host uint32 words (the
    one, the psi constants)."""
    m = field.modulus
    return _words(field, [v % m * field.mont_r % m for v in values])


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


def _check_aligned(name, ts):
    """The staged kernels read and write rows as 16-byte vectors: every
    operand and output must start on a 16-byte boundary."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand at {t.data_ptr():#x} is not 16-byte aligned")


def _check_rc(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _rec(field, muls: int, addsubs: int, n: int):
    """Record a fused kernel's work in the active op counter as the JAX
    package's FieldKernels._rec does for the same call: `muls` products
    and `addsubs` additions or subtractions per element, over n elements
    (utils/profiling.py).  The wrappers record before they pick the
    device, so the CPU and the card count alike."""
    if profiling._active_counter is not None:
        profiling.record(f"mul_{field.nlimb}", muls * n)
        profiling.record(f"add_{field.nlimb}", addsubs * n)


def _plain(fn, *args):
    """A kernel's plain version, run with the op counter suspended: the
    wrapper has recorded the kernel's work already."""
    with profiling.uncounted():
        return fn(*args)


def _binary(name, field, a, b, plain):
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return plain(a, b)
    return _binary_launch(name, field, a, b)


def _binary_launch(name, field, a, b):
    """Launch bls_<name> (mul, add or sub) on broadcast CUDA operands."""
    a, b = _cuda_operands(field, [a, b])
    out = torch.empty_like(a)
    n = a.numel() // field.nlimb
    if n:
        _check_aligned(name, (a, b, out))
        fn = getattr(library(), f"bls_{name}")
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field.nlimb, _p_words(field))
        rc = fn(*ptrs, *((field.n0_word,) if name == "mul" else ()), _stream(a))
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
    _rec(field, 3, 5, a0.numel() // field.nlimb)
    if a0.device.type == "cpu":
        from . import tower

        return _plain(tower.fp2_mul_plain, a0, a1, b0, b1)
    a0, a1, b0, b1 = _cuda_operands(field, [a0, a1, b0, b1])
    c0, c1 = torch.empty_like(a0), torch.empty_like(a0)
    n = a0.numel() // field.nlimb
    if n:
        _check_aligned("fp2_mul", (a0, a1, b0, b1, c0, c1))
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
    _rec(field, 2, 3, a0.numel() // field.nlimb)
    if a0.device.type == "cpu":
        from . import tower

        return _plain(tower.fp2_sqr_plain, a0, a1)
    return _fp2_sqr_launch(field, a0, a1)


def _fp2_sqr_launch(field, a0, a1):
    """Launch bls_fp2_sqr on broadcast CUDA operands."""
    a0, a1 = _cuda_operands(field, [a0, a1])
    c0, c1 = torch.empty_like(a0), torch.empty_like(a0)
    n = a0.numel() // field.nlimb
    if n:
        _check_aligned("fp2_sqr", (a0, a1, c0, c1))
        rc = library().bls_fp2_sqr(
            a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), c1.data_ptr(), n,
            _p_words(field), field.n0_word, _stream(a0),
        )
        _check_rc("fp2_sqr", rc)
        COUNTS.record("fp2_sqr", n)
    return c0, c1


# ----------------------------------------------------------------------------
# kernels on packed (c, N, 24) operands (csrc/pairing_kernels.cu,
# csrc/hash_kernels.cu)
# ----------------------------------------------------------------------------

def _packed_launch(name, field, packed, n_in, n_out, *args, aux=None):
    """Launch kernel `name` on the packed (n_in, N, 24) CUDA operand (and
    the second device operand `aux`, a kernel's masks, table or scalars,
    when given)
    and return its (n_out, N, 24) output.  A contiguous operand is passed
    as it is, without a copy; the wrappers that take several operands pack
    them with one torch.cat, or pass them through one pointer each:
    `packed` and `n_in` are then tuples."""
    if field.nlimb != 24:
        raise ValueError(f"{name} takes Fp (24 limbs), not {field.nlimb}")
    ops = packed if isinstance(packed, tuple) else (packed,)
    widths = n_in if isinstance(n_in, tuple) else (n_in,)
    ops = _cuda_operands(field, list(ops))
    n = ops[0].shape[1] if ops[0].dim() == 3 else -1
    for t, c in zip(ops, widths):
        if t.dim() != 3 or t.shape[0] != c or t.shape[1] != n:
            raise ValueError(f"{name} takes packed {[(c, 'N', 24) for c in widths]} "
                             f"operands, got {[tuple(t.shape) for t in ops]}")
    out = ops[0].new_empty((n_out, n, field.nlimb))
    if n:
        ptrs = [t.data_ptr() for t in ops] + ([] if aux is None else [aux.data_ptr()])
        rc = getattr(library(), f"bls_{name}")(
            *ptrs, out.data_ptr(), n, *args, _p_words(field), field.n0_word, _stream(ops[0])
        )
        _check_rc(name, rc)
        COUNTS.record(name, n)
    return out


def _miller_pack(f, t, per_pair, valid):
    """Check the pair count and the (k, N) valid masks of a Miller launch;
    -> (one packed operand: f, then per pair its T and its `per_pair`
    tensors, (k, N) int32 masks).  _packed_launch checks the limbs."""
    k, n = t.shape[0], f.shape[-2]
    if k not in MILLER_PAIRS:
        raise ValueError(f"the Miller kernels take {MILLER_PAIRS} pairs, got {k}")
    if valid.device != f.device or tuple(valid.shape) != (k, n):
        raise ValueError(f"expected a ({k}, {n}) valid mask on {f.device}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    parts = [f]
    for p in range(k):
        parts += [t[p], *(x[p].reshape(-1, n, 24) for x in per_pair)]
    return torch.cat(parts), valid.to(torch.int32).contiguous()


def fp6_mul(field, a, b):
    """Fp6 product of packed (6, N, 24) operands -> (6, N, 24)
    (replaces FieldKernels.fp6_mul)."""
    _rec(field, 18, 46, a.shape[1])  # 6 Toom Fp2 products + combination adds
    if a.device.type == "cpu":
        from . import tower

        return _plain(tower.fp6_mul_packed_plain, a, b)
    return _packed_launch("fp6_mul", field, torch.cat([a, b]), 12, 6)


def fp12_mul(field, a, b):
    """Fp12 product of packed (12, N, 24) operands -> (12, N, 24)
    (replaces FieldKernels.fp12_mul)."""
    _rec(field, 54, 152, a.shape[1])
    if a.device.type == "cpu":
        from . import tower

        return _plain(tower.fp12_mul_plain, a, b)
    return _packed_launch("fp12_mul", field, torch.cat([a, b]), 24, 12)


def fp12_sqr(field, a):
    """Fp12 square of a packed (12, N, 24) operand (replaces
    FieldKernels.fp12_sqr)."""
    _rec(field, 36, 112, a.shape[1])
    if a.device.type == "cpu":
        from . import tower

        return _plain(tower.fp12_sqr_plain, a)
    return _packed_launch("fp12_sqr", field, a, 12, 12)


def miller_dbl_run(field, f, t, xp, yp, valid, count: int):
    """`count` Miller doubling iterations [f <- f^2; per pair: T, line <-
    dbl_step(T); f <- f * line, neutral where the pair is invalid]
    (replaces FieldKernels.miller_dbl_run).  f (12, N, 24); per pair t
    (k, 6, N, 24) = X, Y, Z, xp and yp (k, N, 24), valid (k, N) bool.
    Returns (f', t')."""
    k = t.shape[0]
    _rec(field, (36 + 70 * k) * count, (112 + 150 * k) * count, f.shape[1])
    if f.device.type == "cpu":
        from . import pairing

        return _plain(pairing.miller_dbl_run_plain, f, t, xp, yp, valid, count)
    if count < 1:
        raise ValueError(f"a doubling run has at least one iteration, got {count}")
    packed, mask = _miller_pack(f, t, (xp, yp), valid)
    out = _packed_launch("miller_dbl_run", field, packed, 12 + 8 * k, 12 + 6 * k,
                         k, count, aux=mask)
    return out[:12], out[12:].view(k, 6, *out.shape[1:])


def miller_add(field, f, t, q, xp, yp, valid):
    """One Miller addition block: per pair T, line <- add_step(T, Q);
    f <- f * line, neutral where the pair is invalid (replaces
    FieldKernels.miller_add).  As miller_dbl_run, with q (k, 4, N, 24) =
    the affine Q's x, y (Fp2 each).  Returns (f', t')."""
    k = t.shape[0]
    _rec(field, 83 * k, 40 + 204 * k, f.shape[1])
    if f.device.type == "cpu":
        from . import pairing

        return _plain(pairing.miller_add_plain, f, t, q, xp, yp, valid)
    packed, mask = _miller_pack(f, t, (q, xp, yp), valid)
    out = _packed_launch("miller_add", field, packed, 12 + 12 * k, 12 + 6 * k, k,
                         aux=mask)
    return out[:12], out[12:].view(k, 6, *out.shape[1:])


def exp_x(field, m, segments):
    """m^e for a packed cyclotomic m (12, N, 24), from f = m at e's top bit:
    per (squares, multiply) in `segments`, that many Granger-Scott squares,
    then f <- f * m if multiply (replaces FieldKernels.exp_x)."""
    nsq = sum(s for s, _ in segments)
    _rec(field, 18 * nsq + 54 * len(segments), 70 * nsq + 152 * len(segments), m.shape[1])
    if m.device.type == "cpu":
        from . import pairing

        return _plain(pairing.exp_x_plain, m, segments)
    lens, muls, nseg = _segments("exp_x", segments)
    return _packed_launch("exp_x", field, m, 12, 12, lens, muls, nseg)


# ----------------------------------------------------------------------------
# the step-wise configuration's kernels (csrc/pairing_kernels.cu): one
# pointer per operand, so T and a line pass from one launch to the next
# as views of its output
# ----------------------------------------------------------------------------

def mul014(field, f, line):
    """f * (c0 + c1 v + c4 v w) for a packed f (12, N, 24) and line (6, N,
    24) = c0, c1, c4 (replaces FieldKernels.mul014).  No mask: an invalid
    pair's caller passes the neutral line."""
    _rec(field, 45, 120, f.shape[1])
    if f.device.type == "cpu":
        from . import pairing

        return _plain(pairing.mul014_plain, f, line)
    return _packed_launch("mul014", field, (f, line), (12, 6), 12)


def dbl_step(field, t, p):
    """One CLN doubling step of T (6, N, 24) = X, Y, Z at the G1 points p
    (2, N, 24) = xp, yp -> (12, N, 24): 2T, then the line c0, c1, c4
    (replaces FieldKernels.dbl_step)."""
    _rec(field, 25, 102, t.shape[1])
    if t.device.type == "cpu":
        from . import pairing

        return _plain(pairing.dbl_step_plain, t, p)
    return _packed_launch("dbl_step", field, (t, p), (6, 2), 12)


def add_step(field, t, q, p):
    """One CLN mixed addition of the affine Q (4, N, 24) = xq, yq to T (6,
    N, 24) at the G1 points p (2, N, 24) -> (12, N, 24): T + Q, then the
    line (replaces FieldKernels.add_step)."""
    _rec(field, 38, 84, t.shape[1])  # the JAX record: 38, not the 41 products the body runs
    if t.device.type == "cpu":
        from . import pairing

        return _plain(pairing.add_step_plain, t, q, p)
    return _packed_launch("add_step", field, (t, q, p), (6, 4, 2), 12)


def cyclo_sqr(field, f, count: int):
    """`count` Granger-Scott squares of a packed (12, N, 24) Fp12, in one
    launch (replaces FieldKernels.cyclo_sqr).  A square only on cyclotomic
    elements; the Fp12 is coefficient-major, as every packed one."""
    _rec(field, 18 * count, 70 * count, f.shape[1])
    if f.device.type == "cpu":
        from . import tower

        return _plain(tower.cyclo_sqr_plain, f, count)
    if count < 1:
        raise ValueError(f"cyclo_sqr squares at least once, got {count}")
    return _packed_launch("cyclo_sqr", field, f, 12, 12, count)


# ----------------------------------------------------------------------------
# hash-stage and subgroup kernels (csrc/hash_kernels.cu)
# ----------------------------------------------------------------------------

def _segments(name, segments):
    """(run lengths, set-bit flags, count) of a ladder's or chain's segments
    as host arrays for the kernel's by-value Segments."""
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"{name} takes at most {MAX_SEGMENTS} segments, got {len(segments)}")
    lens = _host_array(ctypes.c_int, [int(s) for s, _ in segments])
    muls = _host_array(ctypes.c_int, [int(bool(b)) for _, b in segments])
    return lens, muls, len(segments)


def pow_digits(exponent: int):
    """The MSB-first 4-bit digits of a positive exponent (no leading zero)."""
    if exponent < 1:
        raise ValueError(f"pow_win takes a positive exponent, got {exponent}")
    digits = []
    while exponent:
        digits.append(exponent & 15)
        exponent >>= 4
    return digits[::-1]


def _digits(exponent: int):
    """(host digit array, count) of a pow_win exponent."""
    digits = pow_digits(exponent)
    if len(digits) > MAX_DIGITS:
        raise ValueError(f"pow_win takes at most {MAX_DIGITS} digits, got {len(digits)}")
    return _host_array(ctypes.c_ubyte, digits), len(digits)


def _coords(name, a, per_elem):
    """Coordinates per element (1 for Fp, 2 for Fp2) of a packed operand of
    `per_elem` field elements."""
    c = a.shape[0] // per_elem if a.dim() == 3 else 0
    if c not in (1, 2) or a.shape[0] != c * per_elem:
        raise ValueError(f"{name} takes a packed ({per_elem}, N, 24) Fp or "
                         f"({2 * per_elem}, N, 24) Fp2 operand, got {tuple(a.shape)}")
    return c


# the JAX package's fixed window counts of pow_win per coordinate degree,
# which its count charges whatever the exponent (FieldKernels._POW_NWIN)
POW_NWIN = {1: 96, 2: 192}


def pow_win(field, a, exponent: int, nwin: int | None = None):
    """a^exponent for a host-constant exponent > 0, on a packed (c, N, 24)
    operand: c = 1 an Fp, c = 2 an Fp2 (replaces FieldKernels.pow_win).
    The kernel runs the exponent's own digits; the op count charges the
    JAX package's windows: `nwin` where its caller passes one, else
    POW_NWIN."""
    nc = a.shape[0]
    nwin = POW_NWIN.get(nc, 0) if nwin is None else nwin
    _rec(field, (42 + 11 * nwin) if nc == 2 else (14 + 5 * nwin),
         (28 + 5 * nwin) if nc == 2 else 0, a.shape[1])
    if a.device.type == "cpu":
        from . import tower

        return _plain(tower.pow_win_plain, a, exponent)
    c = _coords("pow_win", a, 1)
    digits, ndig = _digits(exponent)
    return _packed_launch("pow_win", field, a, c, c, c, digits, ndig)


def pt_mul_const(field, p, segments):
    """[k]P for the scalar k whose runs after its top bit are `segments`
    (curve.run_segments), on a packed Jacobian point: (3, N, 24) in G1,
    (6, N, 24) in G2 (replaces FieldKernels.pt_mul_const)."""
    _rec_ladder(field, p, segments)
    if p.device.type == "cpu":
        from . import curve

        return _plain(curve.pt_mul_const_plain, p, segments)
    c = _coords("pt_mul_const", p, 3)
    lens, muls, nseg = _segments("pt_mul_const", segments)
    return _packed_launch("pt_mul_const", field, p, 3 * c, 3 * c, c, lens, muls, nseg,
                          _mont_words(field, [1]))


def _rec_ladder(field, p, segments):
    """The JAX package's record of a constant-scalar ladder over a packed
    point: a doubling per run step and a complete addition per segment."""
    g2 = p.shape[0] == 6
    ndbl, nseg = sum(s for s, _ in segments), len(segments)
    _rec(field, (17 if g2 else 8) * ndbl + (58 if g2 else 23) * nseg,
         (40 if g2 else 20) * ndbl + (110 if g2 else 50) * nseg, p.shape[1])


def g2_cofactor(field, p, segments):
    """Budroni-Pintore cofactor clearing [x^2 - x - 1]P + [x - 1]psi(P) +
    psi^2(2P) of a packed (6, N, 24) G2 Jacobian point, with the runs of
    |x| as `segments` (replaces FieldKernels.g2_cofactor)."""
    ndbl, nseg = sum(s for s, _ in segments), len(segments)
    _rec(field, 2 * (17 * ndbl + 58 * nseg) + 58 * 6 + 17 + 8,
         2 * (40 * ndbl + 110 * nseg) + 110 * 6 + 40 + 10, p.shape[1])
    if p.device.type == "cpu":
        from . import curve

        return _plain(curve.g2_cofactor_plain, p, segments)
    lens, muls, nseg = _segments("g2_cofactor", segments)
    return _packed_launch("g2_cofactor", field, p, 6, 6, lens, muls, nseg, psi_words(field),
                          _mont_words(field, [1]))


def psi_words(field):
    """Address of g2_cofactor's psi constants cx, cy (Fp2) and c2 (Fp) as
    host Montgomery words, in the order the kernel takes them."""
    from .. import constants as C

    return _mont_words(field, [*C.PSI_X, *C.PSI_Y, C.PSI2_X_C0])


def sswu_map2(field, u):
    """iso3(map(u0)) + iso3(map(u1)) as a (6, N, 24) Jacobian G2 point, for
    the packed (4, N, 24) u = u0, u1 (Fp2 each) of hash_to_field: both
    SSWU maps, the 3-isogeny and the complete addition in one launch
    (replaces FieldKernels.sswu_map2)."""
    from . import hash_to_g2

    nws = -(-len(pow_digits(hash_to_g2.SQRT_K)) // 8) * 8
    nwi = -(-len(pow_digits(field.modulus - 2)) // 8) * 8
    # per element: 2 maps x (sqrt chain + table + fraction SSWU + isogeny +
    # affine), one shared Fermat chain and the complete addition
    _rec(field, 2 * (11 * nws + 42 + 160) + (5 * nwi + 14) + 36 + 58,
         2 * (5 * nws + 300) + 60 + 110, u.shape[1])
    if u.device.type == "cpu":
        return _plain(hash_to_g2.sswu_map2_plain, u)
    if u.device.type != "cuda":
        raise ValueError(f"sswu_map2 takes CPU or CUDA tensors, got {u.device}")
    table = hash_to_g2.sswu_consts(u.device)
    sqrt_digits, nsqrt = _digits(hash_to_g2.SQRT_K)
    inv_digits, ninv = _digits(field.modulus - 2)
    return _packed_launch("sswu_map2", field, u, 4, 6, sqrt_digits, nsqrt, inv_digits, ninv,
                          _mont_words(field, [1]), aux=table)


# ----------------------------------------------------------------------------
# point kernels of keygen, signing and aggregation (csrc/point_kernels.cu)
# ----------------------------------------------------------------------------

def pt_dbl(field, p, count: int = 1):
    """`count` Jacobian doublings of a packed point: (3, N, 24) in G1,
    (6, N, 24) in G2 (replaces FieldKernels.pt_dbl)."""
    g2 = p.shape[0] == 6
    _rec(field, (17 if g2 else 8) * count, (40 if g2 else 20) * count, p.shape[1])
    if p.device.type == "cpu":
        from . import curve

        return _plain(curve.pt_dbl_plain, p, count)
    if count < 1:
        raise ValueError(f"pt_dbl doubles at least once, got {count}")
    c = _coords("pt_dbl", p, 3)
    return _packed_launch("pt_dbl", field, p, 3 * c, 3 * c, c, count)


def pt_add(field, p, q):
    """Complete Jacobian addition P + Q of packed points of one group and
    shape -> (3c, N, 24) (replaces FieldKernels.pt_add)."""
    g2 = p.shape[0] == 6
    _rec(field, 58 if g2 else 23, 110 if g2 else 50, p.shape[1])
    if p.device.type == "cpu":
        from . import curve

        return _plain(curve.pt_add_plain, p, q)
    c = _coords("pt_add", p, 3)
    if q.shape != p.shape:
        raise ValueError(f"pt_add takes points of one shape, got {tuple(p.shape)} "
                         f"and {tuple(q.shape)}")
    return _packed_launch("pt_add", field, (p, q), (3 * c, 3 * c), 3 * c, c,
                          _mont_words(field, [1]))


def pt_mul_var(field, p, scalars, nbits: int):
    """[s]P for a packed point and per-element scalars s, given as (N, 16)
    int32 raw (non-Montgomery) 16-bit limbs: the MSB-first double-and-add
    ladder over `nbits` bits from the infinity (replaces
    FieldKernels.pt_mul_var)."""
    g2 = p.shape[0] == 6
    _rec(field, (17 + 58 if g2 else 8 + 23) * nbits, (40 + 110 if g2 else 20 + 50) * nbits,
         p.shape[1])
    if p.device.type == "cpu":
        from . import curve

        return _plain(curve.pt_mul_var_plain, p, scalars, nbits)
    c = _coords("pt_mul_var", p, 3)
    if not 1 <= nbits <= 16 * SCALAR_LIMBS:
        raise ValueError(f"pt_mul_var scans 1 to {16 * SCALAR_LIMBS} bits, got {nbits}")
    n = p.shape[1]
    if (scalars.device != p.device or scalars.dtype != torch.int32
            or tuple(scalars.shape) != (n, SCALAR_LIMBS)):
        raise ValueError(f"expected ({n}, {SCALAR_LIMBS}) int32 scalars on {p.device}, got "
                         f"{scalars.dtype} {tuple(scalars.shape)} on {scalars.device}")
    return _packed_launch("pt_mul_var", field, p, 3 * c, 3 * c, c, nbits,
                          _mont_words(field, [1]), aux=scalars.contiguous())


# ----------------------------------------------------------------------------
# expand_message_xmd (csrc/xmd_kernels.cu)
# ----------------------------------------------------------------------------

def xmd(msg, lens, dst: bytes, len_in_bytes: int):
    """expand_message_xmd (RFC 9380 sec 5.3.1, SHA-256) of each row of the
    (..., L) message bytes -> (..., len_in_bytes) uint8: b0 and the b_1 ..
    b_ell chain in one launch.  `lens`: (...,) byte lengths in 0..L, each
    row being its first lens bytes, or None for L each.  Replaces no
    Pallas kernel (the JAX package's jnp SHA-256 and XMD, which XLA
    fuses)."""
    width = msg.shape[-1]
    if lens is not None:
        if tuple(lens.shape) != tuple(msg.shape[:-1]) or lens.device != msg.device:
            raise ValueError(f"expected lens of shape {tuple(msg.shape[:-1])} on {msg.device}, "
                             f"got {tuple(lens.shape)} on {lens.device}")
        if lens.numel() and bool(((lens < 0) | (lens > width)).any()):
            raise ValueError(f"message lengths must lie in 0..{width}")
    from . import hash_to_g2

    if msg.device.type == "cpu":
        return hash_to_g2.xmd_plain(msg, lens, dst, len_in_bytes)
    if msg.device.type != "cuda" or msg.dtype != torch.uint8:
        raise ValueError(f"xmd takes CPU tensors or CUDA uint8 ones, got {msg.dtype} on "
                         f"{msg.device}")
    if msg.device.index != torch.cuda.current_device():
        raise ValueError(f"operands on {msg.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    rows = msg.reshape(-1, width).contiguous()
    n = rows.shape[0]
    out = torch.empty((n, len_in_bytes), dtype=torch.uint8, device=msg.device)
    if n:
        lens32 = None if lens is None else lens.reshape(-1).to(torch.int32).contiguous()
        _xmd_launch(library().bls_xmd, rows, lens32, dst, len_in_bytes, out)
        COUNTS.record("xmd", n)
    return out.reshape(*msg.shape[:-1], len_in_bytes)


def _xmd_launch(fn, rows, lens32, dst: bytes, len_in_bytes: int, out):
    """Launch bls_xmd `fn` on checked operands: rows (n, L) uint8 and
    lens32 (n,) int32 or None, contiguous, on the current device; out (n,
    len_in_bytes) uint8.  No host sync, so a CUDA graph can capture it
    once the table for (dst, len_in_bytes) is cached."""
    from . import hash_to_g2

    table, tlen, nbi = hash_to_g2.xmd_table(dst, len_in_bytes, rows.device)
    _check_rc("xmd", fn(rows.data_ptr(), None if lens32 is None else lens32.data_ptr(),
                        rows.shape[0], rows.shape[1], table.data_ptr(), tlen, nbi,
                        len_in_bytes, out.data_ptr(), _stream(rows)))


# ----------------------------------------------------------------------------
# the R1CS layer's LC dot product (csrc/r1cs_kernels.cu)
# ----------------------------------------------------------------------------

def lc_dot(field, w, idx, coeff):
    """out[b, r] = sum_t w[b, idx[r, t]] * coeff[r, t] (Montgomery products,
    canonical sum mod p) for a (B, V, 24) witness, (R, W) int32 indices in
    [0, V) and (R, W, 24) coefficients -> (B, R, 24).  Replaces no Pallas
    kernel (the JAX package's jnp LC dot, which XLA fuses).  Counted once
    per launch with B * R elements, its size the row width W."""
    # the JAX evaluator's FP ops on the same rows: W products and W - 1
    # additions per row and witness
    terms = w.shape[0] * idx.shape[0]
    profiling.record(f"mul_{field.nlimb}", terms * idx.shape[1])
    profiling.record(f"add_{field.nlimb}", terms * max(idx.shape[1] - 1, 0))
    if w.device.type == "cpu":
        from ..r1cs import evaluator

        return _plain(evaluator.lc_dot_plain, w, idx, coeff)
    if field.nlimb != 24:
        raise ValueError(f"lc_dot takes Fp (24 limbs), not {field.nlimb}")
    w, coeff = _cuda_operands(field, [w, coeff])
    if w.dim() != 3 or coeff.dim() != 3 or idx.dim() != 2 or tuple(coeff.shape[:2]) != tuple(
            idx.shape):
        raise ValueError(f"lc_dot takes w (B, V, 24), idx (R, W), coeff (R, W, 24), got "
                         f"{tuple(w.shape)}, {tuple(idx.shape)}, {tuple(coeff.shape)}")
    if idx.device != w.device or idx.dtype != torch.int32:
        raise ValueError(f"expected int32 indices on {w.device}, got {idx.dtype} on {idx.device}")
    idx = idx.contiguous()
    (b, v, _), (r, width) = w.shape, idx.shape
    out = w.new_empty((b, r, field.nlimb))
    if b and r:
        if not v or not width:
            raise ValueError(f"lc_dot needs V >= 1 and W >= 1, got V = {v}, W = {width}")
        _check_aligned("lc_dot", (w, coeff, out))
        rc = library().bls_lc_dot(w.data_ptr(), idx.data_ptr(), coeff.data_ptr(),
                                  out.data_ptr(), b, v, r, width, _p_words(field),
                                  field.n0_word, _stream(w))
        _check_rc("lc_dot", rc)
        COUNTS.record("lc_dot", b * r, width)
    return out
