"""Host field arithmetic over python ints: Fp and Fp2 (own copy of the
reference package's golden/field.py, the part the port's point codec and
hash-to-G2 constants need).

Representation:
  Fp   : int in [0, P)
  Fp2  : (c0, c1)            meaning c0 + c1*u,       u^2 = -1
"""

from ..constants import P, SQRT_FP_EXP, EULER_FP_EXP

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

FP2_ONE = (1, 0)

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

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
