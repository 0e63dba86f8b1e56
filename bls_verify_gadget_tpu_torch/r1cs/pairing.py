"""In-circuit optimal-ate pairing gadget (replaces the reference's use of
upstream ark_r1cs_std::pairing::bls12::PairingVar, src/constraints.rs:19,
117-125).

Design: affine Miller loop on the M-twist with *hinted slopes* (allocate
lambda, enforce lambda * denom == numer: 3 rows instead of an inversion
subcircuit), sparse mul_by_014 line application, shared accumulator across
pairs, and the same structured final exponentiation as the value paths
(golden/pairing.py, ops/pairing.py) so all three are differential-testable.

Incomplete-addition caveat: the affine step formulas assume the running
accumulator never collides with +-Q mid-loop — unreachable for valid BLS
inputs (it would imply solving a discrete log); infinity inputs are handled
by neutral-line selection.
"""

from __future__ import annotations

from .. import constants as C
from ..golden import field as GF
from .gadgets import FpVar, Boolean
from .fields import (
    Fp2Var, fp6_add, fp6_sub, fp6_neg, fp6_mul, fp6_mul_v,
    fp12_mul, fp12_sqr, fp12_conj, fp12_inverse, fp12_frob, fp12_value,
)

_ABS_X_BITS_MSB = C.ABS_X_BITS[::-1]


def _fp12_one(cs):
    one = Fp2Var.constant(cs, (1, 0))
    z = Fp2Var.constant(cs, (0, 0))
    return ((one, z, z), (z, z, z))


def _fp6_mul_by_01(a, d0, d1):
    p0, p2d1 = a[0] * d0, a[2] * d1
    return (
        p0 + p2d1.mul_xi(),
        a[0] * d1 + a[1] * d0,
        a[1] * d1 + a[2] * d0,
    )


def _fp6_mul_by_1(a, d1):
    return ((a[2] * d1).mul_xi(), a[0] * d1, a[1] * d1)


def fp12_mul_by_014(f, c0, c1, c4):
    a, b = f
    v0 = _fp6_mul_by_01(a, c0, c1)
    v1 = _fp6_mul_by_1(b, c4)
    t = _fp6_mul_by_01(fp6_add(a, b), c0, c1 + c4)
    return (fp6_add(v0, fp6_mul_v(v1)), fp6_sub(t, fp6_add(v0, v1)))


def _hinted_slope(cs, numer: Fp2Var, denom: Fp2Var, nonzero: Boolean | None = None) -> Fp2Var:
    """lambda with lambda * denom == numer enforced.

    Soundness: if denom != 0 the constraint pins lambda uniquely; if
    denom == 0 and numer != 0 it is unsatisfiable.  The dangerous case is
    denom == numer == 0, where lambda would be free.  For DOUBLING steps
    (denom = 2*y1) that case is unreachable: allocation enforces on-curve
    (curve.py alloc_g1/g2) and both group orders are odd, so no on-curve
    point has y == 0 (tests/test_r1cs_adversarial.py).  For ADDITION steps
    (denom = x2 - x1) a malicious SMALL-ORDER twist point — on-curve but
    outside the r-subgroup, which the circuit deliberately does not check
    (reference constraints.rs:101-105) — can drive the Miller accumulator
    back to T == Q and zero both sides.  Passing the pair's validity bit as
    `nonzero` closes that: denom * inv == nonzero forces denom invertible
    whenever the pair is live (matching the reference's enforced-division
    semantics, arkworks PairingVar) while staying satisfiable for
    infinity-masked pairs, whose lines are neutralized anyway (~5 rows per
    addition step)."""
    dval = denom.value
    lam_val = GF.fp2_mul(numer.value, GF.fp2_inv(dval)) if dval != (0, 0) else (0, 0)
    if nonzero is not None:
        inv_val = GF.fp2_inv(dval) if dval != (0, 0) else (0, 0)
        with cs.suppress_tape():
            inv = Fp2Var.alloc(cs, inv_val)
        cs.record(
            "fp2inv0",
            [inv.c0.lc[0][0], inv.c1.lc[0][0]],
            [denom.c0.lc, denom.c1.lc],
        )
        prod = denom * inv
        prod.c0.enforce_equal(nonzero.to_fp())
        prod.c1.enforce_equal(FpVar.constant(cs, 0))
    with cs.suppress_tape():
        lam = Fp2Var.alloc(cs, lam_val)
    cs.record(
        "fp2div0",
        [lam.c0.lc[0][0], lam.c1.lc[0][0]],
        [numer.c0.lc, numer.c1.lc, denom.c0.lc, denom.c1.lc],
    )
    (lam * denom).enforce_equal(numer)
    return lam


def _dbl_step(cs, t, xp: FpVar, yp: FpVar):
    """t = (x1, y1) on the twist; returns (2t, line (c0, c1, c4))."""
    x1, y1 = t
    lam = _hinted_slope(cs, x1.square().scale_fp(3), y1.double())
    x3 = lam.square() - x1.double()
    y3 = lam * (x1 - x3) - y1
    c0 = lam * x1 - y1
    c1 = (-lam).mul_fpvar(xp)
    c4 = Fp2Var(yp, FpVar.constant(cs, 0))
    return (x3, y3), (c0, c1, c4)


def _add_step(cs, t, q, xp: FpVar, yp: FpVar, valid: Boolean | None = None):
    x1, y1 = t
    x2, y2 = q
    lam = _hinted_slope(cs, y2 - y1, x2 - x1, nonzero=valid)
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    c0 = lam * x2 - y2
    c1 = (-lam).mul_fpvar(xp)
    c4 = Fp2Var(yp, FpVar.constant(cs, 0))
    return (x3, y3), (c0, c1, c4)


def _neutral(cs, coeffs, valid: Boolean):
    c0, c1, c4 = coeffs
    one = Fp2Var.constant(cs, (1, 0))
    zero = Fp2Var.constant(cs, (0, 0))
    return (
        c0.select(valid, one),
        c1.select(valid, zero),
        c4.select(valid, zero),
    )


def multi_miller_loop_gadget(cs, pairs):
    """pairs: list of ((xp, yp) FpVars, (xq, yq) Fp2Vars, valid Boolean).
    Returns f (Fp12 gadget), conjugated for x < 0."""
    f = _fp12_one(cs)
    ts = [q for _, q, _ in pairs]
    first = True
    for bit in _ABS_X_BITS_MSB[1:]:
        if not first:
            f = fp12_sqr(f)
        first = False
        new_ts = []
        for i, (p, q, valid) in enumerate(pairs):
            tnew, line = _dbl_step(cs, ts[i], p[0], p[1])
            f = fp12_mul_by_014(f, *_neutral(cs, line, valid))
            if bit:
                tnew, line = _add_step(cs, tnew, q, p[0], p[1], valid=valid)
                f = fp12_mul_by_014(f, *_neutral(cs, line, valid))
            new_ts.append(tnew)
        ts = new_ts
    return fp12_conj(f)  # x < 0


def _exp_by_neg_x(m):
    result = None
    for bit in _ABS_X_BITS_MSB:
        if result is not None:
            result = fp12_sqr(result)
        if bit:
            result = fp12_mul(result, m) if result is not None else m
    return fp12_conj(result)


def final_exponentiation_gadget(f):
    """Same structure as golden/device final exp (easy part + x-chain)."""
    f1 = fp12_mul(fp12_frob(f, 6), fp12_inverse(f))
    m = fp12_mul(fp12_frob(f1, 2), f1)
    t0 = fp12_mul(_exp_by_neg_x(m), fp12_conj(m))
    t1 = fp12_mul(_exp_by_neg_x(t0), fp12_conj(t0))
    t2 = fp12_mul(_exp_by_neg_x(t1), fp12_frob(t1, 1))
    t3 = fp12_mul(
        fp12_mul(_exp_by_neg_x(_exp_by_neg_x(t2)), fp12_frob(t2, 2)),
        fp12_conj(t2),
    )
    m3 = fp12_mul(fp12_sqr(m), m)
    return fp12_mul(t3, m3)


def fp12_is_one_gadget(f) -> Boolean:
    ok = None
    one = (1, 0)
    for c6_idx, c6 in enumerate(f):
        for c2_idx, c2 in enumerate(c6):
            target = Fp2Var.constant(c2.cs, one if (c6_idx == 0 and c2_idx == 0) else (0, 0))
            b = c2.is_eq(target)
            ok = b if ok is None else ok.and_(b)
    return ok


def multi_pairing_gadget(cs, pairs):
    return final_exponentiation_gadget(multi_miller_loop_gadget(cs, pairs))
