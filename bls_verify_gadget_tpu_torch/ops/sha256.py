"""Batched SHA-256 in plain PyTorch, message-parallel (counterpart of the
JAX package's ops/sha256.py): the plain versions that the CPU path runs
and that the xmd kernel (csrc/xmd_kernels.cu) is held to.

Words are int64 tensors holding 32-bit values; every sum is masked with
& 0xFFFFFFFF, so no signed-32-bit wrap is needed.  Input layout:
(..., nblocks, 16) big-endian message words, already padded.
sha256_bytes hashes messages of one byte length; sha256_bytes_var takes
per-element lengths.
"""

import torch

from ..constants import SHA256_IV, SHA256_K

M32 = 0xFFFFFFFF


def _ror(x, n):
    return (x >> n) | ((x << (32 - n)) & M32)


def _compress(state, block):
    """One SHA-256 compression: state (..., 8), block (..., 16) int64."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        s0 = _ror(w[t - 15], 7) ^ _ror(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _ror(w[t - 2], 17) ^ _ror(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for t in range(64):
        s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + (SHA256_K[t] + w[t])
        s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], -1)) & M32


def sha256_words(blocks):
    """blocks: (..., nb, 16) int64 -> digest (..., 8) int64 words."""
    iv = torch.tensor(SHA256_IV, dtype=torch.int64, device=blocks.device)
    state = iv.expand(blocks.shape[:-2] + (8,))
    for blk in blocks.unbind(-2):
        state = _compress(state, blk)
    return state


def bytes_to_padded_words(data_u8, msg_len: int):
    """(..., msg_len) byte values -> padded (..., nb, 16) int64 words with
    the standard SHA-256 padding for the static length msg_len."""
    nb = (msg_len + 8) // 64 + 1
    pad = [0] * (nb * 64 - msg_len)
    pad[0] = 0x80
    bitlen = msg_len * 8
    for i in range(8):
        pad[-8 + i] = (bitlen >> (8 * (7 - i))) & 0xFF
    batch = data_u8.shape[:-1]
    padt = torch.tensor(pad, dtype=torch.int64, device=data_u8.device)
    full = torch.cat([data_u8.to(torch.int64), padt.expand(batch + (len(pad),))], -1)
    b = full.reshape(batch + (nb, 16, 4))
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def words_to_bytes(words):
    """(..., k) big-endian words -> (..., 4k) byte values (int64)."""
    b = torch.stack(
        [(words >> 24) & 0xFF, (words >> 16) & 0xFF, (words >> 8) & 0xFF, words & 0xFF],
        -1,
    )
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 4,))


def sha256_bytes(data_u8, msg_len: int):
    """(..., msg_len) byte tensor -> (..., 32) digest bytes (int64)."""
    return words_to_bytes(sha256_words(bytes_to_padded_words(data_u8, msg_len)))


def sha256_bytes_var(data_u8, lens, max_len: int):
    """Variable-length batched SHA-256, the JAX package's form: every
    element pays the block count of max_len, and its padding and the pick
    of its final state are masks and a gather.

    data_u8: (..., max_len) byte values (bytes past an element's length are
    ignored); lens: (...,) integer byte lengths <= max_len.  Returns
    (..., 32) digest bytes (int64)."""
    nb = (max_len + 8) // 64 + 1
    total = nb * 64
    batch, dev = data_u8.shape[:-1], data_u8.device
    n = lens.to(device=dev, dtype=torch.int64)[..., None]
    buf = torch.cat([data_u8.to(torch.int64),
                     torch.zeros(batch + (total - max_len,), dtype=torch.int64, device=dev)], -1)
    iota = torch.arange(total, device=dev)
    buf = torch.where(iota < n, buf, 0)
    buf = torch.where(iota == n, 0x80, buf)
    # each element's 8 big-endian bit-length bytes end its own final block
    pos0 = ((n + 8) // 64 + 1) * 64 - 8
    in_len = (iota >= pos0) & (iota < pos0 + 8)
    shift = torch.where(in_len, (pos0 + 7 - iota) * 8, 0)
    buf = torch.where(in_len, ((n * 8) >> shift) & 0xFF, buf)
    b = buf.reshape(batch + (nb, 16, 4))
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    iv = torch.tensor(SHA256_IV, dtype=torch.int64, device=dev)
    state, states = iv.expand(batch + (8,)), []
    for blk in words.unbind(-2):
        state = _compress(state, blk)
        states.append(state)
    sel = ((n + 8) // 64)[..., None].expand(batch + (1, 8))
    digest = torch.stack(states, -2).gather(-2, sel)[..., 0, :]
    return words_to_bytes(digest)
