"""Batched modular limb arithmetic (counterpart of the JAX package's
ops/fp.py).

Every op is batch-first over arbitrary leading dims on torch.int32 limb
tensors (..., nlimb): limbs canonical in [0, 2^16), values canonical in
[0, m), in Montgomery form with R = 2^(16*nlimb).  One ModField serves Fp
(24 limbs) and Fr (16 limbs): the instances FP and FR.

mul/add/sub record their work in the active op counter
(utils/profiling.py count_ops) as the JAX package's do: one op per
broadcast element.  They and the Fp power go through ops/kernels.py: a
CUDA tensor launches the hand-written kernel, a CPU tensor runs the plain
versions (mul_plain/add_plain/sub_plain here, pow_win_plain in
ops/tower.py).  The plain versions compute in int64 -- a 16x16-bit
product overflows int32,
and torch's CPU uint32 lacks add, shift and compare -- and return exactly
the kernels' canonical limbs.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from ..utils import profiling
from . import kernels as K
from .limbs import int_to_limbs, ints_to_limbs, limbs_to_int

BITS = C.LIMB_BITS
MASK = C.LIMB_MASK
_M48 = (1 << 48) - 1
_CHUNK_SHIFTS = (0, 16, 32)


def _carry(cols):
    """(N, k) int64 columns (k a multiple of 3, |column| < 2^29) -> the
    canonical 16-bit limbs of their value mod 2^(16k), and the signed
    carry out of the top limb.  Three limbs form one 48-bit chunk, so the
    sequential chain runs k/3 steps."""
    n, k = cols.shape
    w = cols.new_tensor([1 << s for s in _CHUNK_SHIFTS])
    chunks = (cols.view(n, k // 3, 3) * w).sum(-1)
    out = []
    c = torch.zeros_like(chunks[:, 0])
    for ch in chunks.unbind(-1):
        v = ch + c
        out.append(v & _M48)
        c = v >> 48
    sh = cols.new_tensor(_CHUNK_SHIFTS)
    limbs = (torch.stack(out, -1)[..., None] >> sh) & MASK
    return limbs.reshape(n, k), c


def _pad3(x):
    """Right-pad the limb axis with zero columns to a multiple of 3."""
    return F.pad(x, (0, (-x.shape[-1]) % 3))


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' is given"
        )
    return dev


class ModField:
    """Montgomery arithmetic mod `modulus` with nlimb 16-bit limbs."""

    def __init__(self, modulus: int, nlimb: int):
        self.modulus = modulus
        self.nlimb = nlimb
        self.mont_r = 1 << (BITS * nlimb)
        assert self.mont_r > 2 * modulus
        # per-16-bit-limb factor (plain version) and per-32-bit-word factor
        # (CUDA kernels): different constants for the same R
        self.n0 = (-pow(modulus, -1, 1 << BITS)) % (1 << BITS)
        self.n0_word = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self._host = {
            "P": int_to_limbs(modulus, nlimb),
            "ONE": int_to_limbs(self.mont_r % modulus, nlimb),
            "R2": int_to_limbs(self.mont_r**2 % modulus, nlimb),
            "R3": int_to_limbs(self.mont_r**3 % modulus, nlimb),
        }
        self._consts = {}

    def const(self, name: str, device, dtype=torch.int32):
        """A constant limb vector ("P", "ONE", "R2", "R3") on `device`."""
        key = (name, torch.device(device), dtype)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(self._host[name]).to(device=device, dtype=dtype)
            self._consts[key] = t
        return t

    def one_like(self, a):
        return self.const("ONE", a.device).expand(a.shape)

    def constant(self, x: int, device):
        """Host int -> its Montgomery limb vector on `device` (cached)."""
        key = (x, torch.device(device))
        t = self._consts.get(key)
        if t is None:
            t = self.encode(x, device)
            self._consts[key] = t
        return t

    # ------------------------------------------------------------------
    # host conversions
    # ------------------------------------------------------------------

    def encode(self, xs, device="cuda"):
        """Host int(s) -> Montgomery limb tensor (int32) on `device`."""
        device = resolve_device(device)
        if isinstance(xs, int):
            arr = int_to_limbs(xs % self.modulus * self.mont_r % self.modulus, self.nlimb)
        else:
            arr = ints_to_limbs(
                [x % self.modulus * self.mont_r % self.modulus for x in xs], self.nlimb
            )
        return torch.as_tensor(arr).to(device)

    def decode(self, limbs):
        """Montgomery limb tensor -> host ints (nested lists)."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.cpu().numpy()
        arr = np.asarray(limbs)
        rinv = pow(self.mont_r, -1, self.modulus)

        def rec(a):
            if a.ndim == 1:
                return limbs_to_int(a) * rinv % self.modulus
            return [rec(row) for row in a]

        return rec(arr)

    # ------------------------------------------------------------------
    # ring ops (kernel wrappers)
    # ------------------------------------------------------------------

    def _record(self, kind: str, a, b):
        """Op accounting (utils/profiling.count_ops): one `kind` op per
        broadcast batch element, as the JAX package's ModField._record."""
        if profiling._active_counter is not None:
            shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
            profiling.record(f"{kind}_{self.nlimb}", math.prod(shape))

    def add(self, a, b):
        self._record("add", a, b)
        return K.add(self, a, b)

    def sub(self, a, b):
        self._record("sub", a, b)
        return K.sub(self, a, b)

    def mul(self, a, b):
        self._record("mul", a, b)
        return K.mul(self, a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def sqr(self, a):
        return self.mul(a, a)

    # ------------------------------------------------------------------
    # plain versions of the kernels (int64, any device)
    # ------------------------------------------------------------------

    def _flat64(self, *ts):
        return [t.reshape(-1, self.nlimb).to(torch.int64) for t in ts]

    def _select_reduced(self, s):
        """(N, k) canonical limbs of a value in [0, 2m) -> [0, m)."""
        p = _pad3(self.const("P", s.device, torch.int64))
        d, borrow = _carry(s - p[: s.shape[-1]])
        return torch.where((borrow < 0)[:, None], s, d)

    def add_plain(self, a, b):
        """Plain version of the add kernel: canonical (a + b) mod m."""
        shape = a.shape
        a, b = self._flat64(a, b)
        s, _ = _carry(_pad3(a + b))
        out = self._select_reduced(s)[:, : self.nlimb]
        return out.to(torch.int32).reshape(shape)

    def sub_plain(self, a, b):
        """Plain version of the sub kernel: canonical (a - b) mod m."""
        shape = a.shape
        a, b = self._flat64(a, b)
        p = _pad3(self.const("P", a.device, torch.int64))
        d, borrow = _carry(_pad3(a - b))
        e, _ = _carry(d + p)
        out = torch.where((borrow < 0)[:, None], e, d)[:, : self.nlimb]
        return out.to(torch.int32).reshape(shape)

    def mul_plain(self, a, b):
        """Plain version of the mul kernel: Montgomery a*b*R^-1 mod m for
        a, b < 2m, canonical output.  Full product by a skewed sum of the
        limb outer product, then 16-bit-digit REDC over lazy int64 columns
        (each stays < 2^39), then carry and one conditional subtraction."""
        shape = a.shape
        n = self.nlimb
        a, b = self._flat64(a, b)
        rows = a.shape[0]
        prod = a[:, :, None] * b[:, None, :]
        t = F.pad(prod, (0, n)).reshape(rows, 2 * n * n)[:, : n * (2 * n - 1)]
        t = t.reshape(rows, n, 2 * n - 1).sum(1)
        t = F.pad(t, (0, 1))
        p = self.const("P", a.device, torch.int64)
        for i in range(n):
            m = (t[:, i] * self.n0) & MASK
            t[:, i : i + n] += m[:, None] * p
            t[:, i + 1] += t[:, i] >> BITS
        r = _pad3(t[:, n:])  # value < 2m in lazy columns
        r = (r & MASK) + F.pad(r >> BITS, (1, 0))[:, :-1]
        s, _ = _carry(r)
        out = self._select_reduced(s)[:, :n]
        return out.to(torch.int32).reshape(shape)

    # ------------------------------------------------------------------
    # plain-torch helpers (glue, as in the reference's jnp path)
    # ------------------------------------------------------------------

    def propagate(self, cols):
        """(..., k) non-negative limb columns (< 2^29) -> canonical limbs
        (same k); the caller guarantees the value fits k limbs."""
        shape = cols.shape
        x = cols.reshape(-1, shape[-1]).to(torch.int64)
        s, _ = _carry(_pad3(x))
        return s[:, : shape[-1]].to(torch.int32).reshape(shape)

    def cond_sub_mod(self, s):
        """Reduce canonical limbs of a value in [0, 2m) to [0, m)."""
        shape = s.shape
        x = _pad3(s.reshape(-1, self.nlimb).to(torch.int64))
        return self._select_reduced(x)[:, : self.nlimb].to(torch.int32).reshape(shape)

    def mul_small(self, a, k: int):
        """a * k for a small host constant (0 < k < 8)."""
        assert 0 < k < 8
        r = self.propagate(a * k)
        for _ in range(k - 1):
            r = self.cond_sub_mod(r)
        return r

    def cmov(self, cond, a, b):
        return torch.where(cond[..., None], a, b)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def to_mont(self, x):
        return self.mul(x, self.const("R2", x.device))

    def from_mont(self, x):
        one = torch.zeros_like(x)
        one[..., 0] = 1
        return self.mul(x, one)

    # ------------------------------------------------------------------
    # exponentiation over constant exponents
    # ------------------------------------------------------------------

    def pow_const(self, a, exponent: int):
        """a^exponent (Montgomery in/out) for a host-constant exponent.  Fp:
        ONE pow_win launch (table and every window in the kernel).  Fr (off
        the verify path, and without a pow_win kernel in the JAX package):
        4-bit windows, MSB first, 4 squarings + one table multiply each, on
        the mul kernel."""
        if exponent == 0:
            return self.one_like(a).clone()
        if self.nlimb == C.NLIMB:
            return K.pow_win(self, a.reshape(1, -1, self.nlimb), exponent).reshape(a.shape)
        digits = K.pow_digits(exponent)
        tab = [self.one_like(a), a]
        for i in range(2, 16):
            tab.append(self.mul(tab[i - 1], a))
        f = self.one_like(a)
        for d in digits:
            for _ in range(4):
                f = self.mul(f, f)
            f = self.mul(f, tab[d])
        return f

    def inv(self, a):
        """a^-1 via Fermat; 0 -> 0."""
        return self.pow_const(a, self.modulus - 2)

    def sqrt_3mod4(self, a):
        """Candidate sqrt a^((m+1)/4); valid iff its square equals a."""
        return self.pow_const(a, (self.modulus + 1) // 4)


FP = ModField(C.P, C.NLIMB)
FR = ModField(C.R, C.NLIMB_FR)
