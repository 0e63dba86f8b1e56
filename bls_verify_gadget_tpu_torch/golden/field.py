"""Golden field tower: Fp, Fp2, Fp6, Fp12 over python ints (own copy of
the reference package's golden/field.py, plus fp2_sqrt_candidate_root).

Representation:
  Fp   : int in [0, P)
  Fp2  : (c0, c1)            meaning c0 + c1*u,       u^2 = -1
  Fp6  : (a0, a1, a2)        meaning a0 + a1*v + a2*v^2, v^3 = xi = 1+u
  Fp12 : (b0, b1)            meaning b0 + b1*w,       w^2 = v

Parity: replaces the reference's use of ark-ff Fp/Fp2/Fp6/Fp12
(reference Cargo.toml:17, src/hasher.rs:7).
"""

from ..constants import (
    P, Q2, XI, FROB6_C1, FROB6_C2, FROB12_C1, SQRT_FP_EXP, EULER_FP_EXP,
)

# ----------------------------------------------------------------------------
# Fp
# ----------------------------------------------------------------------------

def fp_add(a, b):
    return (a + b) % P

def fp_sub(a, b):
    return (a - b) % P

def fp_mul(a, b):
    return (a * b) % P

def fp_neg(a):
    return (-a) % P

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

def fp_sgn0(a):
    return a & 1

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

def fp2_muls(a, s):
    """Multiply by an Fp scalar."""
    return (a[0] * s % P, a[1] * s % P)

def fp2_conj(a):
    return (a[0], (-a[1]) % P)

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

def fp2_is_zero(a):
    return a[0] == 0 and a[1] == 0

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
# Fp6 = Fp2[v]/(v^3 - xi)
# ----------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)

def fp2_mul_xi(a):
    """Multiply by xi = 1 + u:  (c0 - c1) + (c0 + c1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)

def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))

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

# ----------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ----------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)

def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))

def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))

def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    v0 = fp6_mul(a0, b0)
    v1 = fp6_mul(a1, b1)
    c0 = fp6_add(v0, fp6_mul_v(v1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(v0, v1))
    return (c0, c1)

def fp12_sqr(a):
    a0, a1 = a
    v0 = fp6_mul(a0, a1)
    t = fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_v(a1)))
    c0 = fp6_sub(fp6_sub(t, v0), fp6_mul_v(v0))
    c1 = fp6_add(v0, v0)
    return (c0, c1)

def fp12_conj(a):
    """Conjugate (= inverse for elements of the cyclotomic subgroup)."""
    return (a[0], fp6_neg(a[1]))

def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_v(fp6_sqr(a1)))
    ti = fp6_inv(t)
    return (fp6_mul(a0, ti), fp6_neg(fp6_mul(a1, ti)))

def fp12_pow(a, e):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    r = FP12_ONE
    b = a
    while e:
        if e & 1:
            r = fp12_mul(r, b)
        b = fp12_sqr(b)
        e >>= 1
    return r

def fp12_is_one(a):
    return a == FP12_ONE

def _fp4_sqr(a, b):
    """(a + b V)^2 in Fp4 = Fp2[V]/(V^2 - xi): (a^2 + xi b^2, 2ab)."""
    t0 = fp2_sqr(a)
    t1 = fp2_sqr(b)
    t2 = fp2_sub(fp2_sqr(fp2_add(a, b)), fp2_add(t0, t1))
    return (fp2_add(t0, fp2_mul_xi(t1)), t2)


def fp12_cyclotomic_sqr(f):
    """Granger-Scott squaring for elements of the cyclotomic subgroup
    (valid after the easy part of the final exponentiation): 9 Fp2 squares
    instead of a full Fp12 square.  Mapping validated numerically against
    fp12_sqr."""
    a, b = f
    z = (a[0], b[1], b[0], a[2], a[1], b[2])
    t00, t01 = _fp4_sqr(z[0], z[1])
    t20, t21 = _fp4_sqr(z[2], z[3])
    t40, t41 = _fp4_sqr(z[4], z[5])

    def m3m2(t, zz):  # 3t - 2z
        r = fp2_sub(t, zz)
        r = fp2_add(r, r)
        return fp2_add(r, t)

    def p3p2(t, zz):  # 3t + 2z
        r = fp2_add(t, zz)
        r = fp2_add(r, r)
        return fp2_add(r, t)

    z0n = m3m2(t00, z[0])
    z1n = p3p2(t01, z[1])
    z2n = p3p2(fp2_mul_xi(t41), z[2])
    z3n = m3m2(t40, z[3])
    z4n = m3m2(t20, z[4])
    z5n = p3p2(t21, z[5])
    return ((z0n, z4n, z3n), (z2n, z1n, z5n))


# Frobenius maps: (x + y u)^p = x - y u, then tower coefficients.

def fp6_frob(a, power):
    i = power % 6
    def c(x):
        return fp2_conj(x) if power % 2 else x
    return (
        c(a[0]),
        fp2_mul(c(a[1]), FROB6_C1[i]),
        fp2_mul(c(a[2]), FROB6_C2[i]),
    )

def fp12_frob(a, power):
    i = power % 12
    c0 = fp6_frob(a[0], power)
    c1 = fp6_frob(a[1], power)
    # multiply the w-part coefficients by FROB12_C1[i]
    c1 = tuple(fp2_mul(x, FROB12_C1[i]) for x in c1)
    return (c0, c1)
