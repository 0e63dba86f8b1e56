"""Batched witness generation for the SHA-256 and XMD gadgets on the device
(counterpart of the JAX package's r1cs/device_witness.py).

The R1CS builder produces ONE circuit; proving a batch of messages needs a
batch of witness vectors.  This module generates the SHA-256 gadget's
witness segment for a whole batch at once: a word-level mirror of
r1cs/sha256.py's allocation stream.

Every witness the gadget allocates is a bit of some 32-bit word of the SHA
trace, or a {0, 1, p-1} select/choose hint, so the mirror runs batched
SHA-256 word arithmetic and emits, in exact allocation order, index planes
into the 3-entry Montgomery table [0, 1, p-1].  Constant folding: the
gadget skips allocations when operand bits are circuit constants
(Boolean.xor/and_ fold, select_bool never folds), so each mirrored word
carries a constant-bit mask and the emission positions replicate the fold
rules exactly.

Words are int64 tensors holding values below 2^32 (torch's CPU uint32
lacks shifts and adds, ops/fp.py); every result that could pass 2^32 is
masked back.  Eager PyTorch, ~10^4 word operations per SHA block; the xmd
kernel yields only digests, not every intermediate bit.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..constants import SHA256_IV, SHA256_K
from ..ops.fp import FP

_M32 = 0xFFFFFFFF
ALL_CONST = 0xFFFFFFFF

# table indices for witness values
IDX_ZERO, IDX_ONE, IDX_MINUS_ONE = 0, 1, 2


class _Emitter:
    """Collects (B, k) planes of table indices in allocation order."""

    def __init__(self, device):
        self.planes = []
        self.device = device
        self._shifts = torch.arange(32, dtype=torch.int64, device=device)[None, :]

    def bits(self, word, positions):
        """Emit the given bit positions (ascending) of a (B,) word as 0/1
        table indices."""
        if not positions:
            return
        pos = torch.as_tensor(positions, dtype=torch.int64, device=self.device)
        self.planes.append((word[:, None] >> pos[None, :]) & 1)

    def all_bits(self, word):
        return (word[:, None] >> self._shifts) & 1

    def signed(self, plus_word, minus_word):
        """Emit 32 per-bit values (plus_bit - minus_bit) in {-1, 0, 1} as
        table indices {2, 0, 1} (p-1, 0, 1)."""
        p, m = self.all_bits(plus_word), self.all_bits(minus_word)
        self.planes.append(torch.where(p >= m, p - m, IDX_MINUS_ONE))

    def concat(self, batch):
        if not self.planes:
            return torch.zeros((batch, 0), dtype=torch.int64, device=self.device)
        return torch.cat(self.planes, dim=1)


class _W:
    """Batched 32-bit word + constant-bit tracking.

    val: (B,) int64 values below 2^32 (correct for every bit, constant or
    not); cmask: int, bit i set -> bit i is a circuit constant (same for
    the whole batch); the constant values are val's (batch-uniform on
    constant bits by construction)."""

    __slots__ = ("val", "cmask")

    def __init__(self, val, cmask: int):
        self.val = val
        self.cmask = cmask & ALL_CONST

    def rotr(self, r):
        r %= 32
        if r == 0:
            return _W(self.val, self.cmask)
        val = ((self.val >> r) | (self.val << (32 - r))) & _M32
        cm = ((self.cmask >> r) | (self.cmask << (32 - r))) & ALL_CONST
        return _W(val, cm)

    def shr(self, s):
        # top s bits become constant zeros
        return _W(self.val >> s, (self.cmask >> s) | (ALL_CONST << (32 - s)))


def _const_word(batch, v: int, device):
    return _W(torch.full((batch,), v, dtype=torch.int64, device=device), ALL_CONST)


def _xor(a: _W, b: _W, em: _Emitter) -> _W:
    """Boolean.xor parity: allocates exactly where BOTH bits are non-const;
    result bit is constant iff both are."""
    alloc = ~a.cmask & ~b.cmask & ALL_CONST
    out = _W(a.val ^ b.val, a.cmask & b.cmask)
    em.bits(out.val, [i for i in range(32) if (alloc >> i) & 1])
    return out


def _small_sigma(w: _W, r1, r2, s, em):
    return _xor(_xor(w.rotr(r1), w.rotr(r2), em), w.shr(s), em)


def _big_sigma(w: _W, r1, r2, r3, em):
    return _xor(_xor(w.rotr(r1), w.rotr(r2), em), w.rotr(r3), em)


def _addmany(terms, k_const, em: _Emitter) -> _W:
    """UInt32.addmany parity: allocates 32 output bits + carry bits.
    k_const is added as an extra constant term (round constants).  The
    carry word is the sum's bits above 32: the count of wraps mod 2^32."""
    nterms = len(terms) + (1 if k_const is not None else 0)
    total = terms[0].val
    for t in terms[1:]:
        total = total + t.val
    if k_const is not None:
        total = total + k_const
    lo, hi = total & _M32, total >> 32
    em.planes.append(em.all_bits(lo))
    carry_bits = max(1, (nterms - 1).bit_length())
    em.bits(hi, list(range(carry_bits)))
    return _W(lo, 0)


def _ch(e: _W, f: _W, g: _W, em: _Emitter) -> _W:
    """select_bool per bit: ALWAYS allocates w = ch_bit - g_bit (select_fp
    never constant-folds)."""
    ch = (e.val & f.val) ^ (~e.val & g.val)
    em.signed(ch, g.val)
    return _W(ch, 0)


def _maj(a: _W, b: _W, c: _W, em: _Emitter) -> _W:
    """_maj parity: per bit, t = b&c allocates iff BOTH bits are non-const
    (Boolean.and_ folds when either operand is constant); then
    w = maj - t = maj & ~t (in {0,1}) always allocates.  Emission order is
    (t?, w) per bit, LSB first."""
    t = b.val & c.val
    maj = (a.val & b.val) ^ (a.val & c.val) ^ (b.val & c.val)
    w = maj & ~t  # maj >= t bitwise, so maj - t == maj & ~t
    t_alloc = (~b.cmask) & (~c.cmask) & ALL_CONST
    if t_alloc == ALL_CONST:
        # steady state (both operands fresh): interleave [t0,w0,t1,w1,...]
        tb, wb = em.all_bits(t), em.all_bits(w)
        em.planes.append(torch.stack([tb, wb], dim=-1).reshape(t.shape[0], 64))
    elif t_alloc == 0:
        em.planes.append(em.all_bits(w))
    else:
        for i in range(32):
            if (t_alloc >> i) & 1:
                em.bits(t, [i])
            em.bits(w, [i])
    return _W(maj, 0)


def _compress(state, block_words, em):
    w = list(block_words)
    for t in range(16, 64):
        s0 = _small_sigma(w[t - 15], 7, 18, 3, em)
        s1 = _small_sigma(w[t - 2], 17, 19, 10, em)
        w.append(_addmany([w[t - 16], s0, w[t - 7], s1], None, em))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _big_sigma(e, 6, 11, 25, em)
        ch = _ch(e, f, g, em)
        t1 = _addmany([h, S1, ch, w[t]], SHA256_K[t], em)
        S0 = _big_sigma(a, 2, 13, 22, em)
        maj = _maj(a, b, c, em)
        t2 = _addmany([S0, maj], None, em)
        h, g, f, e = g, f, e, _addmany([d, t1], None, em)
        d, c, b, a = c, b, a, _addmany([t1, t2], None, em)
    return [_addmany([x, y], None, em) for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _sha_stream(byts, em, batch):
    """One sha256_gadget call over a mixed const/witness byte stream:
    byts = list of (value (B,) int64, is_const) pairs -- the gadget's
    msg_bytes argument.  Appends the host-static padding, emits the trace
    segment into `em`, and returns the 32 digest bytes as (value, False)
    pairs (digest bits are always fresh addmany witnesses)."""
    dev = em.device
    L = len(byts)
    pad = [0x80]
    while (L + len(pad)) % 64 != 56:
        pad.append(0)
    bitlen = L * 8
    pad += [(bitlen >> (8 * (7 - i))) & 0xFF for i in range(8)]
    data = byts + [(torch.full((batch,), p, dtype=torch.int64, device=dev), True) for p in pad]

    state = [_const_word(batch, iv, dev) for iv in SHA256_IV]
    for off in range(0, len(data), 64):
        words = []
        for i in range(16):
            b4 = data[off + 4 * i: off + 4 * i + 4]
            val = (b4[0][0] << 24) | (b4[1][0] << 16) | (b4[2][0] << 8) | b4[3][0]
            cm = 0
            for k, (_, is_c) in enumerate(b4):  # byte k holds bits 24-8k..31-8k
                if is_c:
                    cm |= 0xFF << (24 - 8 * k)
            words.append(_W(val, cm))
        state = _compress(state, words, em)
    out = []
    for w in state:  # _u32_to_bytes_be order
        for k in (24, 16, 8, 0):
            out.append(((w.val >> k) & 0xFF, False))
    return out


def _message_bytes(msgs_u8, msg_len):
    msgs = torch.as_tensor(msgs_u8).to(torch.int64)
    return msgs, [(msgs[:, i], False) for i in range(msg_len)]


def sha256_gadget_witness_indices(msgs_u8, msg_len: int):
    """Mirror of r1cs/sha256.sha256_gadget's witness allocation stream.

    msgs_u8: (B, msg_len) byte values (any integer tensor, on the device
    the mirror runs on); the message bytes are assumed to be allocated
    UInt8 witnesses (as in r1cs/hasher.py), the padding is circuit
    constants.  Returns (B, W) int64 table indices into [0, 1, p-1] -- one
    column per witness the gadget allocates, in exact allocation order (the
    gadget's own msg-byte allocations are NOT included; they precede this
    segment)."""
    msgs, byts = _message_bytes(msgs_u8, msg_len)
    em = _Emitter(msgs.device)
    _sha_stream(byts, em, msgs.shape[0])
    return em.concat(msgs.shape[0])


def xmd_witness_indices(msgs_u8, msg_len: int, dst: bytes, len_in_bytes: int):
    """Mirror of r1cs/hasher.expand_message_xmd_gadget's witness stream
    (which is also hash_to_field_gadget's whole stream -- the byte-to-field
    recombination is a pure linear combination, zero witnesses).

    Segments, in allocation order: the b0 SHA over Z_pad||msg||lib||0||DST',
    the b1 SHA over b0||1||DST', then per extra block the 256 Boolean.xor
    bits of b0^prev (all fresh: both operands are witness bits) followed by
    that block's SHA.  Returns (B, W) int64 indices into [0, 1, p-1]."""
    msgs, byts = _message_bytes(msgs_u8, msg_len)
    B, dev = msgs.shape[0], msgs.device
    ell = -(-len_in_bytes // 32)
    if ell > 255 or len(dst) > 255:
        raise ValueError(f"expand_message_xmd takes at most {255 * 32} bytes out and a DST of "
                         f"at most 255 bytes, got {len_in_bytes} and {len(dst)}")

    def const_bytes(bs):
        return [(torch.full((B,), b, dtype=torch.int64, device=dev), True) for b in bs]

    dst_prime = const_bytes(dst + bytes([len(dst)]))
    em = _Emitter(dev)
    b0_in = (
        const_bytes([0] * 64)
        + byts
        + const_bytes(len_in_bytes.to_bytes(2, "big"))
        + const_bytes([0])
        + dst_prime
    )
    b0 = _sha_stream(b0_in, em, B)
    prev = _sha_stream(b0 + const_bytes([1]) + dst_prime, em, B)
    for i in range(2, ell + 1):
        x = []
        for (av, _), (bv, _) in zip(b0, prev):
            xv = av ^ bv
            em.bits(xv, list(range(8)))  # UInt8.xor: 8 fresh bits, LSB first
            x.append((xv, False))
        prev = _sha_stream(x + const_bytes([i]) + dst_prime, em, B)
    return em.concat(B)


def witness_table(device):
    """(3, 24) Montgomery limbs of [0, 1, p-1], the values the indices
    select."""
    return FP.encode([0, 1, C.P - 1], device)


def sha256_gadget_witness_limbs(msgs_u8, msg_len: int):
    """As sha256_gadget_witness_indices, but materialised as Montgomery
    limb planes (B, W, 24) -- the segment evaluator.encode_witness_batch
    gives for these columns."""
    idx = sha256_gadget_witness_indices(msgs_u8, msg_len)
    return witness_table(idx.device)[idx]
