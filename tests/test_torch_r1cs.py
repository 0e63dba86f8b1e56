"""The port's R1CS builders (bls_verify_gadget_tpu_torch/r1cs) against the
JAX package's: the same seeded small circuits built by both give equal
assignments, tapes, constraint counts and to_arrays() output.  All of it
is python-int arithmetic: every comparison is exact."""

import random
import types

import numpy as np
import pytest

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import field as JGF
from bls_verify_gadget_tpu.r1cs import (
    curve as jcurve, fields as jfields, gadgets as jgadgets, hasher as jhasher,
    pairing as jpairing, sha256 as jsha, system as jsystem,
)
from bls_verify_gadget_tpu_torch.golden import field as TGF
from bls_verify_gadget_tpu_torch.r1cs import (
    curve as tcurve, fields as tfields, gadgets as tgadgets, hasher as thasher,
    pairing as tpairing, sha256 as tsha, system as tsystem,
)

P = JC.P
JAX = types.SimpleNamespace(system=jsystem, gadgets=jgadgets, fields=jfields, curve=jcurve,
                            sha256=jsha, hasher=jhasher, pairing=jpairing)
PORT = types.SimpleNamespace(system=tsystem, gadgets=tgadgets, fields=tfields, curve=tcurve,
                             sha256=tsha, hasher=thasher, pairing=tpairing)


def _fp_arith(m, cs, rng):
    FpVar = m.gadgets.FpVar
    a, b = FpVar.alloc(cs, rng.randrange(P)), FpVar.alloc(cs, rng.randrange(P))
    zero = FpVar.alloc(cs, 0)
    c = (a * b + a.double() - b.scale(7)).square()
    c = c - FpVar.constant(cs, 5) + (-a)
    inv = c.inverse()
    i0, z0 = zero.inverse_or_zero()
    i1, z1 = a.inverse_or_zero()
    bits = FpVar.alloc(cs, rng.randrange(1 << 20)).to_bits_le(20)
    bits += a.to_bits_le_canonical()[:3]
    sel = a.select(bits[0], b)
    eq = a.is_eq(sel)
    (inv * c).enforce_equal(FpVar.constant(cs, 1))
    return [c, inv, i0, z0, i1, z1, eq, *bits]


def _fp2(m, cs, rng):
    Fp2Var = m.fields.Fp2Var
    a = Fp2Var.alloc(cs, (rng.randrange(P), rng.randrange(P)))
    b = Fp2Var.alloc(cs, (0, rng.randrange(P)))
    zero = Fp2Var.alloc(cs, (0, 0))
    inv = a.inverse()
    i0, z0 = zero.inverse_or_zero()
    i1, z1 = b.inverse_or_zero()
    return [inv, i0, z0, i1, z1, a.sgn0(), b.sgn0(), zero.sgn0(), (a * b).square().mul_xi()]


def _curve(m, cs, rng):
    g1 = m.curve.alloc_g1(cs, JC.G1_GEN)
    g2 = m.curve.alloc_g2(cs, JC.G2_GEN)
    out = []
    for p in (g1, g2):
        d = m.curve.pt_double(p)
        s = m.curve.pt_add(d, p)
        out += [d, s, m.curve.pt_scalar_mul_const(p, 11), m.curve.pt_add(s, s.negate())]
    return out


def _miller_steps(m, cs, rng):
    """One Miller doubling and one masked addition step (hinted slopes)
    and their lines into f."""
    p = m.curve.alloc_g1(cs, JC.G1_GEN)
    q = m.curve.alloc_g2(cs, JC.G2_GEN)
    valid = m.gadgets.Boolean.alloc(cs, 1)
    t, line = m.pairing._dbl_step(cs, (q.x, q.y), p.x, p.y)
    f = m.pairing.fp12_mul_by_014(m.pairing._fp12_one(cs), *m.pairing._neutral(cs, line, valid))
    t, line = m.pairing._add_step(cs, t, (q.x, q.y), p.x, p.y, valid=valid)
    return t, m.pairing.fp12_mul_by_014(f, *m.pairing._neutral(cs, line, valid))


def _sha24(m, cs, rng):
    msg = [m.gadgets.UInt8.alloc(cs, rng.randrange(256)) for _ in range(24)]
    return m.sha256.sha256_gadget(cs, msg)


def _xmd(m, cs, rng):
    msg = [m.gadgets.UInt8.alloc(cs, rng.randrange(256)) for _ in range(8)]
    return m.hasher.expand_message_xmd_gadget(cs, msg, JC.DST_G2, 64)


def _map(m, cs, rng):
    u = m.fields.Fp2Var.alloc(cs, (rng.randrange(P), rng.randrange(P)))
    return m.hasher.map_to_curve_gadget(u)


def _fp6_rand(rng):
    return tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))


def _fp6_inv(m, cs, rng):
    a = tuple(m.fields.Fp2Var.alloc(cs, c) for c in _fp6_rand(rng))
    return m.fields.fp6_inverse(a)


def _fp12_inv(m, cs, rng):
    a = tuple(tuple(m.fields.Fp2Var.alloc(cs, c) for c in _fp6_rand(rng)) for _ in range(2))
    return m.fields.fp12_inverse(a)


CIRCUITS = {"fp_arith": _fp_arith, "fp2": _fp2, "curve": _curve,
            "miller_steps": _miller_steps, "sha256_24": _sha24,
            "xmd": _xmd, "map_to_curve": _map, "fp6_inverse": _fp6_inv,
            "fp12_inverse": _fp12_inv}


def build(m, name, seed):
    cs = m.system.ConstraintSystem()
    CIRCUITS[name](m, cs, random.Random(seed))
    return cs


def assert_same_circuit(jcs, tcs):
    assert tcs.num_constraints == jcs.num_constraints
    assert tcs.assignments == jcs.assignments
    assert tcs.is_instance == jcs.is_instance
    assert tcs.tape == jcs.tape  # kind, outs, lcs, meta of every entry
    assert (tcs.a_rows, tcs.b_rows, tcs.c_rows) == (jcs.a_rows, jcs.b_rows, jcs.c_rows)
    ja, ta = jcs.to_arrays(), tcs.to_arrays()
    assert set(ta) == set(ja)
    for k, v in ja.items():
        if k == "num_vars":
            assert ta[k] == v
        else:
            assert ta[k].dtype == v.dtype and ta[k].shape == v.shape, k
            assert np.array_equal(ta[k], v), k
    assert tcs.assignments == jcs.assignments  # the partial sums to_arrays appended
    assert tcs.aux_splits == jcs.aux_splits


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_builders_make_the_same_circuit(name):
    jcs, tcs = build(JAX, name, 0x1900 + len(name)), build(PORT, name, 0x1900 + len(name))
    assert tcs.is_satisfied()
    assert_same_circuit(jcs, tcs)


def test_builders_record_every_kind_of_the_tape():
    """Between them the small circuits record every kind that the witness
    VM executes (tests/test_torch_r1cs_device.py replays them)."""
    kinds = {e["kind"] for name in ("fp_arith", "map_to_curve", "fp6_inverse", "fp12_inverse",
                                    "miller_steps", "sha256_24")
             for e in build(PORT, name, 1).tape}
    assert kinds == {"input", "mul", "xor", "bits", "inv", "inv0", "fp2inv0", "fp2inv0z",
                     "fp2div0", "sqrt2", "fp6inv", "fp12inv"}


def test_golden_field_additions_match():
    """The functions the gadgets call that the port's golden field gained:
    fp2_sub, fp2_sgn0, fp6_inv, fp12_inv (and their helpers)."""
    rng = random.Random(0x19)
    for _ in range(5):
        a = (rng.randrange(P), rng.randrange(P))
        b = (rng.randrange(P), rng.randrange(P))
        assert TGF.fp2_sub(a, b) == JGF.fp2_sub(a, b)
        assert TGF.fp2_sgn0(a) == JGF.fp2_sgn0(a)
        a6 = _fp6_rand(rng)
        assert TGF.fp6_inv(a6) == JGF.fp6_inv(a6)
        a12 = (_fp6_rand(rng), _fp6_rand(rng))
        assert TGF.fp12_inv(a12) == JGF.fp12_inv(a12)
    for a in ((0, 0), (0, 1), (0, 2), (P - 1, 0), (2, 3)):
        assert TGF.fp2_sgn0(a) == JGF.fp2_sgn0(a)


def test_verify_gadget_builds_the_same_prefix():
    """The verify gadget's allocation front (parameters, pk, message bytes,
    signature) and its input encoding are the same in both packages; the
    whole 601,320-constraint circuit is built on the card machine by
    chip_smoke.py, not here."""
    from bls_verify_gadget_tpu.golden import bls as gbls
    from bls_verify_gadget_tpu.r1cs import verify as jverify
    from bls_verify_gadget_tpu_torch.r1cs import verify as tverify

    sk = 0x1234567
    pk, sig = gbls.sk_to_pk(sk), gbls.sign(sk, b"m")
    css = []
    for m, v in ((JAX, jverify), (PORT, tverify)):
        cs = m.system.ConstraintSystem()
        v.ParametersVar.constant(cs)
        v.PublicKeyVar.alloc(cs, pk)
        [m.gadgets.UInt8.alloc(cs, b) for b in b"message bytes"]
        v.SignatureVar.alloc(cs, sig).to_bytes_le()
        css.append(cs)
    assert_same_circuit(*css)
