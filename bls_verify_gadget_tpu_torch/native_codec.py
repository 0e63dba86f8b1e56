"""ctypes wrapper of the port's native C++ host codec (native/bls_host.cpp):
batch decompression with full validation, and batch compression, of ZCash
compressed G1 (48-byte) and G2 (96-byte) points.

The library is built on first use: native/gen_constants.py writes
constants.h from the port's constants.py, then `g++ -O3 -shared -fPIC`
compiles the source into build/libbls_host_<hash>.so (named by a hash of
the source, the header and the flags, so an edit rebuilds).  Nothing is
built when the module is imported.  A failed build or load raises with the
compiler's output; nothing here falls back to the golden codec, which
stays a separate call (golden/bls.py).

API (host boundary):
  g1_decompress_batch(list of 48-byte strings) -> list of (x, y) | None
      (the infinity) | reject reason (str)
  g2_decompress_batch(list of 96-byte strings) -> the same in G2
  g1_compress_batch(points) -> list of 48-byte strings
  g2_compress_batch(points) -> list of 96-byte strings
  decode_pubkeys / decode_signatures(blobs, device) -> (the device batch
      that BatchedBLS.verify takes, a (B,) uint8 status tensor)
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from .native import gen_constants
from .ops.fp import FP, resolve_device
from .ops import tower as T

PKG_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = PKG_DIR / "native" / "bls_host.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

STATUS_OK = 0
STATUS_INF = 1
REJECT_REASONS = {2: "bad flags", 3: "x out of range", 4: "not on curve", 5: "not in subgroup"}

_lib = None
_lib_lock = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(gen_constants.header().encode())
    return BUILD_DIR / f"libbls_host_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Generate constants.h and compile the codec unless it is built."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native codec: g++ not found on PATH")
    tag = f"{so.name}.{os.getpid()}"
    inc = BUILD_DIR / f"{tag}.include"
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        gen_constants.emit(inc)
        res = subprocess.run([cxx, *CXX_FLAGS, "-I", str(inc), "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native codec: g++ failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(inc, ignore_errors=True)
    return so


def library():
    """The loaded codec library (built on first call); raises if it cannot
    be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, size = ctypes.c_void_p, ctypes.c_size_t
            for g in ("g1", "g2"):
                dec = getattr(lib, f"bls_{g}_decompress_batch")
                dec.argtypes, dec.restype = [vp, size, vp, vp], ctypes.c_int
                enc = getattr(lib, f"bls_{g}_compress_batch")
                enc.argtypes, enc.restype = [vp, vp, size, vp], None
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _decompress(group: str, blobs, nbytes: int):
    """-> (canonical big-endian affine coordinates (n, 2 * nbytes) uint8,
    status (n,) uint8) from the library."""
    blobs = list(blobs)
    bad = [i for i, b in enumerate(blobs) if len(b) != nbytes]
    if bad:
        raise ValueError(f"{group}_decompress_batch takes {nbytes}-byte strings; "
                         f"elements {bad[:8]} have other lengths")
    n = len(blobs)
    raw = np.frombuffer(b"".join(blobs), np.uint8)
    xy = np.zeros((n, 2 * nbytes), np.uint8)
    status = np.zeros(n, np.uint8)
    getattr(library(), f"bls_{group}_decompress_batch")(
        raw.ctypes.data, n, xy.ctypes.data, status.ctypes.data)
    return xy, status


def _coords(xy):
    """(n, 48 k) big-endian bytes -> k lists of n ints."""
    k = xy.shape[1] // 48
    rows = [r.tobytes() for r in xy]
    return [[int.from_bytes(r[48 * j: 48 * j + 48], "big") for r in rows] for j in range(k)]


def _points(group, xy, status):
    cols = _coords(xy)
    out = []
    for i, st in enumerate(status.tolist()):
        if st == STATUS_OK:
            c = [col[i] for col in cols]
            out.append((c[0], c[1]) if group == "g1" else ((c[0], c[1]), (c[2], c[3])))
        elif st == STATUS_INF:
            out.append(None)
        else:
            out.append(REJECT_REASONS.get(st, "reject"))
    return out


def g1_decompress_batch(blobs):
    """48-byte strings -> list of (x, y) | None (infinity) | reject reason."""
    return _points("g1", *_decompress("g1", blobs, 48))


def g2_decompress_batch(blobs):
    """96-byte strings -> list of ((x0, x1), (y0, y1)) | None | reject reason."""
    return _points("g2", *_decompress("g2", blobs, 96))


def _compress(group: str, coords_of, points, nbytes: int):
    n = len(points)
    xy = bytearray(2 * nbytes * n)
    inf = np.zeros(max(n, 1), np.uint8)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            xy[2 * nbytes * i: 2 * nbytes * (i + 1)] = b"".join(
                c.to_bytes(48, "big") for c in coords_of(p))
    src = np.frombuffer(bytes(xy), np.uint8) if n else np.zeros(1, np.uint8)
    out = np.zeros(max(nbytes * n, 1), np.uint8)
    getattr(library(), f"bls_{group}_compress_batch")(
        src.ctypes.data, inf.ctypes.data, n, out.ctypes.data)
    raw = out.tobytes()
    return [raw[nbytes * i: nbytes * (i + 1)] for i in range(n)]


def g1_compress_batch(points):
    """Affine G1 points (None = infinity) -> 48-byte strings."""
    return _compress("g1", lambda p: p, points, 48)


def g2_compress_batch(points):
    """Affine G2 points (None = infinity) -> 96-byte strings."""
    return _compress("g2", lambda p: (*p[0], *p[1]), points, 96)


# ----------------------------------------------------------------------------
# wire bytes -> device batches
# ----------------------------------------------------------------------------

def decode_pubkeys(blobs, device="cuda"):
    """48-byte compressed pubkeys -> ((x, y, is_inf), status): the affine
    Montgomery limb batch that models/bls.encode_pubkeys makes of the
    decoded points, and a (B,) uint8 tensor of the codec's status codes
    (STATUS_OK, STATUS_INF, REJECT_REASONS).  A rejected element is
    encoded as the infinity, so verify gives it False; its status says
    why."""
    dev = resolve_device(device)
    xy, status = _decompress("g1", blobs, 48)
    x, y = _coords(xy)
    inf = status != STATUS_OK
    y = [1 if i else v for v, i in zip(y, inf.tolist())]
    pk = (FP.encode(x, dev), FP.encode(y, dev), torch.from_numpy(inf).to(dev))
    return pk, torch.from_numpy(status).to(dev)


def decode_signatures(blobs, device="cuda"):
    """96-byte compressed signatures -> (((x0, x1), (y0, y1), is_inf),
    status), as decode_pubkeys: the batch models/bls.encode_signatures
    makes of the decoded points.  A rejected element is encoded as the
    infinity, which verify accepts as a signature: callers mask verify's
    result with status <= STATUS_INF."""
    dev = resolve_device(device)
    xy, status = _decompress("g2", blobs, 96)
    x0, x1, y0, y1 = _coords(xy)
    inf = status != STATUS_OK
    y0 = [1 if i else v for v, i in zip(y0, inf.tolist())]
    x = T.fp2_encode_batch(list(zip(x0, x1)), dev)
    y = T.fp2_encode_batch(list(zip(y0, y1)), dev)
    return (x, y, torch.from_numpy(inf).to(dev)), torch.from_numpy(status).to(dev)
