"""In-circuit SHA-256 over UInt32 gadgets (Sha256Gadget parity — the
reference uses ark_crypto_primitives::Sha256Gadget, src/hasher.rs:19,139).

Interface is byte-level (UInt8 vars), padding is host-static (message
lengths are known at circuit-build time, matching the device path's
static-shape contract)."""

from __future__ import annotations

from ..constants import SHA256_IV, SHA256_K
from .gadgets import UInt8, UInt32, Boolean


def _u32_from_bytes_be(b4):
    """4 UInt8 -> UInt32 (big-endian bytes)."""
    cs = b4[0].cs
    bits = []
    # little-endian bit order within the word: byte 3 holds bits 0..7
    for byte in reversed(b4):
        bits.extend(byte.bits)
    value = (b4[0].value << 24) | (b4[1].value << 16) | (b4[2].value << 8) | b4[3].value
    return UInt32(cs, bits, value)


def _u32_to_bytes_be(w: UInt32):
    cs = w.cs
    out = []
    for i in (3, 2, 1, 0):
        bits = w.bits[8 * i : 8 * i + 8]
        out.append(UInt8(cs, bits, (w.value >> (8 * i)) & 0xFF))
    return out


def _small_sigma(w: UInt32, r1, r2, s):
    return w.rotr(r1).xor(w.rotr(r2)).xor(w.shr(s))


def _big_sigma(w: UInt32, r1, r2, r3):
    return w.rotr(r1).xor(w.rotr(r2)).xor(w.rotr(r3))


def _ch(e, f, g):
    """ch(e,f,g) = e ? f : g — one select row per bit (vs 3 rows for the
    literal and/xor form)."""
    bits = [eb.select_bool(fb, gb) for eb, fb, gb in zip(e.bits, f.bits, g.bits)]
    from .gadgets import UInt32 as U

    return U(e.cs, bits, (e.value & f.value) ^ (~e.value & g.value))


def _maj(a, b, c):
    """maj per bit via t = b*c; maj = t + a*(b + c - 2t) — 2 rows per bit
    (vs 5 for the and/xor form)."""
    from .gadgets import Boolean, UInt32 as U

    cs = a.cs
    m = cs.field_mod
    out_bits = []
    for ab, bb, cb in zip(a.bits, b.bits, c.bits):
        t = bb.and_(cb)
        # s = b + c - 2t  (0/1-valued), maj = t + a*s
        from .gadgets import _merge

        s_lc = _merge(_merge(bb.lc, cb.lc, mod=m), t.lc, 1, -2, mod=m)
        s_val = (bb.value + cb.value - 2 * t.value) % m
        maj_val = (t.value + ab.value * s_val) % m
        w = cs.new_witness((maj_val - t.value) % m)
        cs.record("mul", [w], [ab.lc, s_lc])
        cs.enforce(ab.lc, s_lc, [(w, 1)])
        out_bits.append(Boolean(cs, _merge(t.lc, [(w, 1)], mod=m), maj_val))
    return U(a.cs, out_bits, (a.value & b.value) ^ (a.value & c.value) ^ (b.value & c.value))


def _compress(cs, state, block_words):
    w = list(block_words)
    for t in range(16, 64):
        s0 = _small_sigma(w[t - 15], 7, 18, 3)
        s1 = _small_sigma(w[t - 2], 17, 19, 10)
        w.append(UInt32.addmany([w[t - 16], s0, w[t - 7], s1]))
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _big_sigma(e, 6, 11, 25)
        ch = _ch(e, f, g)
        t1 = UInt32.addmany([h, S1, ch, UInt32.constant(cs, SHA256_K[t]), w[t]])
        S0 = _big_sigma(a, 2, 13, 22)
        maj = _maj(a, b, c)
        t2 = UInt32.addmany([S0, maj])
        h, g, f, e = g, f, e, UInt32.addmany([d, t1])
        d, c, b, a = c, b, a, UInt32.addmany([t1, t2])
    return [
        UInt32.addmany([x, y])
        for x, y in zip(state, (a, b, c, d, e, f, g, h))
    ]


def sha256_gadget(cs, msg_bytes: list[UInt8]) -> list[UInt8]:
    """SHA-256 of a byte-gadget message -> 32 byte gadgets."""
    L = len(msg_bytes)
    # standard padding with host-known length
    pad = [UInt8.constant(cs, 0x80)]
    while (L + len(pad)) % 64 != 56:
        pad.append(UInt8.constant(cs, 0))
    bitlen = L * 8
    for i in range(8):
        pad.append(UInt8.constant(cs, (bitlen >> (8 * (7 - i))) & 0xFF))
    data = msg_bytes + pad
    state = [UInt32.constant(cs, iv) for iv in SHA256_IV]
    for off in range(0, len(data), 64):
        words = [
            _u32_from_bytes_be(data[off + 4 * i : off + 4 * i + 4]) for i in range(16)
        ]
        state = _compress(cs, state, words)
    out = []
    for wd in state:
        out.extend(_u32_to_bytes_be(wd))
    return out
