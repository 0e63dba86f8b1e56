"""Host field arithmetic over python ints: Fp, Fp2, and the Fp6 and Fp12
inverses (own copy of the reference package's golden/field.py, the part the
port's point codec, hash-to-G2 constants and R1CS gadgets need).

Representation:
  Fp   : int in [0, P)
  Fp2  : (c0, c1)            meaning c0 + c1*u,       u^2 = -1
  Fp6  : (a0, a1, a2)        meaning a0 + a1*v + a2*v^2, v^3 = xi = 1+u
  Fp12 : (b0, b1)            meaning b0 + b1*w,       w^2 = v
"""

from ..constants import P, Q2, SQRT_FP_EXP, EULER_FP_EXP

# ----------------------------------------------------------------------------
# Fp
# ----------------------------------------------------------------------------

def fp_inv(a):
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, P - 2, P)

def fp_sqrt(a):
    """Return sqrt or None.  p == 3 mod 4."""
    if a == 0:
        return 0
    s = pow(a, SQRT_FP_EXP, P)
    return s if s * s % P == a else None

def fp_is_square(a):
    return a == 0 or pow(a, EULER_FP_EXP, P) == 1

# ----------------------------------------------------------------------------
# Fp2
# ----------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)

def fp2_mul(a, b):
    # u^2 = -1
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )

def fp2_sqr(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)

def fp2_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ni = fp_inv(n)
    return (a[0] * ni % P, (-a[1] * ni) % P)

def fp2_pow(a, e):
    r = FP2_ONE
    b = a
    while e:
        if e & 1:
            r = fp2_mul(r, b)
        b = fp2_sqr(b)
        e >>= 1
    return r

def fp2_is_square(a):
    """a is a square in Fp2 iff norm(a) is a square in Fp."""
    n = (a[0] * a[0] + a[1] * a[1]) % P
    return fp_is_square(n)

def fp2_sqrt(a):
    """Square root in Fp2 via the norm trick (p == 3 mod 4), or None.

    For a = x + y*u: norm n = x^2 + y^2; if n is a QR, m = sqrt(n); then
    alpha = (x + m)/2 or (x - m)/2 (one of them is a QR); s = sqrt(alpha),
    t = y / (2 s); result s + t*u.
    """
    x, y = a
    if y == 0:
        s = fp_sqrt(x)
        if s is not None:
            return (s, 0)
        # -1 is a non-residue, so -x must be a QR; sqrt(x) = sqrt(-x) * u
        s = fp_sqrt((-x) % P)
        if s is None:
            return None
        return (0, s)
    n = (x * x + y * y) % P
    m = fp_sqrt(n)
    if m is None:
        return None
    inv2 = fp_inv(2)
    alpha = (x + m) * inv2 % P
    s = fp_sqrt(alpha)
    if s is None:
        alpha = (x - m) * inv2 % P
        s = fp_sqrt(alpha)
        if s is None:
            return None
    if s == 0:
        return None
    t = y * fp_inv(2 * s % P) % P
    cand = (s, t)
    if fp2_sqr(cand) == (x % P, y % P):
        return cand
    return None

# the multipliers c of z = a^((p^2 + 7)/16) whose z * c may be a square
# root, in the order the device's fp2_sqrt_candidates tries them: 1, u,
# sqrt(u), sqrt(-u)
_SQRT_CANDIDATES = ((1, 0), (0, 1), fp2_sqrt((0, 1)), fp2_sqrt((0, P - 1)))


def fp2_sqrt_candidate_root(a):
    """The square root of a that ops/hash_to_g2.py fp2_sqrt_candidates
    (and the JAX package's function of that name) returns: the first z * c
    over _SQRT_CANDIDATES whose square is a, or None.  fp2_sqrt may return
    its negation: a square has two roots."""
    z = fp2_pow(a, (Q2 + 7) // 16)
    for c in _SQRT_CANDIDATES:
        t = fp2_mul(z, c)
        if fp2_sqr(t) == (a[0] % P, a[1] % P):
            return t
    return None

def fp2_sgn0(a):
    """RFC 9380 sgn0 for m=2 (reference src/hasher.rs:520-530)."""
    s0 = a[0] & 1
    z0 = a[0] == 0
    s1 = a[1] & 1
    return s0 | (int(z0) & s1)

# ----------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v): the inverses
# ----------------------------------------------------------------------------

def fp2_mul_xi(a):
    """Multiply by xi = 1 + u:  (c0 - c1) + (c0 + c1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)

def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))

def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)

def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = fp2_mul(a0, b0)
    v1 = fp2_mul(a1, b1)
    v2 = fp2_mul(a2, b2)
    c0 = fp2_add(v0, fp2_mul_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(v1, v2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(v0, v1)), fp2_mul_xi(v2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(v0, v2)), v1)
    return (c0, c1, c2)

def fp6_sqr(a):
    return fp6_mul(a, a)

def fp6_mul_v(a):
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fp2_mul_xi(a[2]), a[0], a[1])

def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))), fp2_mul(a0, c0))
    ti = fp2_inv(t)
    return (fp2_mul(c0, ti), fp2_mul(c1, ti), fp2_mul(c2, ti))

def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_v(fp6_sqr(a1)))
    ti = fp6_inv(t)
    return (fp6_mul(a0, ti), fp6_neg(fp6_mul(a1, ti)))
