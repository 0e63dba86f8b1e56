"""Host-side int <-> limb conversion (own copy of the reference package's
ops/limbs.py).

Device representation of a field element: little-endian 16-bit limbs in a
torch.int32 tensor of shape (..., nlimb), batch-first.  Fp uses 24 limbs
(384 bits), Fr uses 16 limbs (256 bits).  The integers are the same as the
JAX package's uint32 limbs; field elements on the device are kept in
Montgomery form (x * 2^(16*nlimb) mod m), see ops/fp.py.
"""

import numpy as np

from ..constants import LIMB_BITS, LIMB_MASK


def int_to_limbs(x: int, nlimb: int) -> np.ndarray:
    """Single int -> (nlimb,) int32 little-endian limb vector."""
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimb)], dtype=np.int32
    )


def ints_to_limbs(xs, nlimb: int) -> np.ndarray:
    """Sequence of ints -> (len(xs), nlimb) int32, one to_bytes per int."""
    buf = b"".join(x.to_bytes(nlimb * 2, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimb)
    return arr.astype(np.int32)


def limbs_to_int(limbs) -> int:
    """(nlimb,) limb vector (any integer dtype) -> int."""
    acc = 0
    for v in reversed(np.asarray(limbs).tolist()):
        acc = (acc << LIMB_BITS) | int(v)
    return acc


def limbs_to_ints(limbs):
    """(..., nlimb) -> nested lists of ints with shape (...)."""
    limbs = np.asarray(limbs)
    if limbs.ndim == 1:
        return limbs_to_int(limbs)
    return [limbs_to_ints(row) for row in limbs]
