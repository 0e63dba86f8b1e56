"""BLS12-381 curve constants of the PyTorch/CUDA port: its own copy of
bls_verify_gadget_tpu/constants.py, shared by the port's golden (python-int)
host helpers and its torch device path.

All constants are plain python ints (arbitrary precision) or tuples thereof;
the device path converts them to limb tensors via ops.limbs.

Parity notes (reference = lightec-xyz/bls-verify-gadget):
  * ciphersuite DST: reference src/bls.rs:482, src/hasher.rs:734
  * SSWU E2' constants A'=(0,240), B'=(1012,1012), Z=(-2,-1):
    reference src/hasher.rs:229-240
  * C1 = (q-9)/16 with q = p^2: reference src/hasher.rs:242
  * h_eff for G2 cofactor clearing: reference src/hasher.rs:663-673
    (RFC 9380 sec 8.8.2)
"""

# ----------------------------------------------------------------------------
# Base field / scalar field
# ----------------------------------------------------------------------------

# BLS12-381 base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# subgroup order r (255 bits)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative).  |x| = 0xd201000000010000, hamming weight 6.
X = -0xD201000000010000
ABS_X = -X
ABS_X_BITS = [(ABS_X >> i) & 1 for i in range(ABS_X.bit_length())]  # LSB first

# curve equations: G1: y^2 = x^3 + 4 over Fp;  G2: y^2 = x^3 + 4(1+u) over Fp2
B_G1 = 4
B_G2 = (4, 4)

# cofactors
H_G1 = 0x396C8C005555E1568C00AAAB0000AAAB
H_G2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

# effective G2 cofactor for cofactor clearing (RFC 9380 sec 8.8.2); the
# reference's slow in-circuit clear_cofactor2 multiplies by this scalar
# (src/hasher.rs:663-673).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# ----------------------------------------------------------------------------
# Generators
# ----------------------------------------------------------------------------

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# ----------------------------------------------------------------------------
# Hash-to-curve (G2, RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_)
# ----------------------------------------------------------------------------

# ETH2 proof-of-possession ciphersuite DST (reference src/bls.rs:482)
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# L = ceil((ceil(log2(p)) + k) / 8) = ceil((381+128)/8) = 64 bytes per base
# field element (reference LEN_PER_BASE_ELEM, src/hasher.rs:27)
L_FIELD = 64
M_EXT = 2      # extension degree of Fp2
HASH_COUNT = 2 # elements produced by hash_to_field

# SSWU isogenous curve E2': y^2 = x^3 + A'x + B' over Fp2
# (reference src/hasher.rs:229-240)
SSWU_A = (0, 240)
SSWU_B = (1012, 1012)
SSWU_Z = (P - 2, P - 1)  # Z = -(2 + u)

# 3-isogeny map E2' -> G2 coefficients (RFC 9380 Appendix E.3).
# x_num has degree 3, x_den degree 2 (monic), y_num degree 3, y_den degree 3
# (monic).  Each coefficient is an Fp2 element (c0, c1).
ISO3_XNUM = (
    (
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    (
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    (
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
)
ISO3_XDEN = (
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    (
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    (1, 0),
)
ISO3_YNUM = (
    (
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    (
        0,
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    (
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
)
ISO3_YDEN = (
    (
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    (
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    (1, 0),
)

# ----------------------------------------------------------------------------
# Derived constants (computed, not hand-copied)
# ----------------------------------------------------------------------------

Q2 = P * P                 # order of Fp2
SQRT_FP_EXP = (P + 1) // 4 # p == 3 mod 4
EULER_FP_EXP = (P - 1) // 2
C1_9MOD16 = (Q2 - 9) // 16  # matches reference src/hasher.rs:242

assert P % 4 == 3
assert Q2 % 16 == 9

# limb layout for the device path: 24 little-endian 16-bit limbs (384 bits)
NLIMB = 24
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_BITS = NLIMB * LIMB_BITS          # 384
MONT_R = 1 << MONT_BITS                # Montgomery radix
MONT_R_MOD_P = MONT_R % P
MONT_R2_MOD_P = (MONT_R * MONT_R) % P
MONT_R3_MOD_P = (MONT_R * MONT_R * MONT_R) % P
# -p^-1 mod 2^16 (per-limb Montgomery factor)
P_INV_NEG_LIMB = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

# Fr limb layout: 16 limbs of 16 bits (256 bits)
NLIMB_FR = 16
MONT_BITS_FR = NLIMB_FR * LIMB_BITS    # 256
MONT_R_FR = 1 << MONT_BITS_FR
MONT_R_MOD_R = MONT_R_FR % R
MONT_R2_MOD_R = (MONT_R_FR * MONT_R_FR) % R
R_INV_NEG_LIMB = (-pow(R, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def _fp2_pow(a, e):
    """Minimal local Fp2 pow used only to derive constants below."""
    c0, c1 = 1, 0
    b0, b1 = a
    while e:
        if e & 1:
            c0, c1 = (c0 * b0 - c1 * b1) % P, (c0 * b1 + c1 * b0) % P
        b0, b1 = (b0 * b0 - b1 * b1) % P, (2 * b0 * b1) % P
        e >>= 1
    return (c0, c1)


def _fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fp2_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(n, P - 2, P)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


# Fp6/Fp12 tower non-residue xi = 1 + u  (Fp6 = Fp2[v]/(v^3 - xi),
# Fp12 = Fp6[w]/(w^2 - v))
XI = (1, 1)

# Frobenius coefficients for the tower.
#   FROB_FP2: conjugation (no constant needed)
#   FROB6_C1[i] = xi^((p^i - 1) / 3)        for Fp6 c1 coefficient
#   FROB6_C2[i] = xi^((2 p^i - 2) / 3)      for Fp6 c2 coefficient
#   FROB12_C1[i] = xi^((p^i - 1) / 6)       for Fp12 w coefficient
FROB6_C1 = tuple(_fp2_pow(XI, (P**i - 1) // 3) for i in range(6))
FROB6_C2 = tuple(_fp2_pow(XI, (2 * P**i - 2) // 3) for i in range(6))
FROB12_C1 = tuple(_fp2_pow(XI, (P**i - 1) // 6) for i in range(12))

# psi (untwist-Frobenius-twist) endomorphism constants for G2:
#   psi(x, y) = (PSI_X * conj(x), PSI_Y * conj(y))
# with PSI_X = 1 / xi^((p-1)/3), PSI_Y = 1 / xi^((p-1)/2).
PSI_X = _fp2_inv(FROB6_C1[1])
PSI_Y = _fp2_inv(_fp2_pow(XI, (P - 1) // 2))
# psi^2 acts on x with a constant in Fp (conjugations cancel):
#   psi2(x, y) = (PSI2_X * x, -y)
PSI2_X = _fp2_mul(PSI_X, (PSI_X[0], (-PSI_X[1]) % P))
assert PSI2_X[1] == 0
PSI2_X_C0 = PSI2_X[0]

# GLV / subgroup-check endomorphism for G1: phi(x, y) = (BETA * x, y) acts as
# multiplication by a cube root of unity lambda mod r.


def _find_beta():
    # beta is a primitive cube root of unity in Fp: beta = g^((p-1)/3) for a
    # generator g; use small candidates.
    for g in range(2, 50):
        b = pow(g, (P - 1) // 3, P)
        if b != 1 and pow(b, 3, P) == 1:
            return b
    raise AssertionError("no cube root of unity found")


BETA_G1 = _find_beta()
# the two cube roots; the subgroup check picks the one with
# phi(P) == -x^2 * P on the subgroup; resolved/validated in golden tests.
BETA_G1_ALT = pow(BETA_G1, 2, P)

# Fp2 sqrt candidate multipliers for q == 9 mod 16 (device path):
# z = a^((q+7)/16); the true sqrt is z * d for d in SQRT_FP2_CANDIDATES.
# d in {1, s(-1), s(s(-1)), s(-s(-1))} where s() denotes any fixed sqrt.
# These are derived in golden/field.py (needs the Fp2 sqrt itself) and
# validated by tests; computed lazily there to avoid a cycle.

SHA256_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SHA256_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
