"""The round-wise bodies of the group kernels (ops/group_rounds.py, the
tables of csrc/group_rounds.cuh that csrc/group.cuh runs) on the CPU: the
committed header is the generator's output, and each body run on Python
ints as the kernels run it (run_body: phase by phase, every form and
product with the kernels' bounds checked) gives the limbs of the plain
versions of miller_dbl_run and exp_x (ops/pairing.py) on seeded random
operands, off the curve and off the cyclotomic subgroup, with mixed valid
masks.  Tolerance 0."""

import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.ops import group_rounds as GR
from bls_verify_gadget_tpu_torch.ops import pairing as PR
from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int

N = 3  # elements


def packed(rng, coords):
    """(coords, N, 24) canonical limbs from seeded ints, and the ints."""
    vals = [[int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(N)]
            for _ in range(coords)]
    return torch.from_numpy(np.stack([ints_to_limbs(v, 24) for v in vals])), vals


def ints(t):
    return [[limbs_to_int(t[c, i].numpy()) for i in range(t.shape[1])] for c in range(t.shape[0])]


def test_header_is_the_generators_output():
    assert GR.HEADER.read_text() == GR.render()


def test_exp_x_bodies_match_the_plain_version():
    segments = [(2, True), (1, False), (3, True)]
    m, vals = packed(np.random.default_rng(70), 12)
    want = ints(PR.exp_x_plain(m, segments))
    P = GR.exp_x_program()
    for i in range(N):
        slots = [0] * P.nslots
        for c in range(12):
            slots[c] = vals[c][i]
        GR.run_body(P, "setup", slots)
        for length, mul in segments:
            for _ in range(length):
                GR.run_body(P, "square", slots)
            if mul:
                GR.run_body(P, "mul", slots)
        assert slots[:12] == [want[c][i] for c in range(12)]


@pytest.mark.parametrize("k", GR.MILLER_PAIRS)
def test_miller_bodies_match_the_plain_version(k):
    rng = np.random.default_rng(71 + k)
    f, fv = packed(rng, 12)
    t, tv = packed(rng, 6 * k)
    p, pv = packed(rng, 2 * k)
    valid = torch.tensor([[True, False, True], [True, True, False]][:k])
    count = 2
    want_f, want_t = PR.miller_dbl_run_plain(f, t.view(k, 6, N, 24), p[0::2], p[1::2], valid,
                                             count)
    want = ints(torch.cat([want_f, want_t.reshape(6 * k, N, 24)]))
    P = GR.miller_program(k)
    for i in range(N):
        slots = [0] * P.nslots
        for c in range(12):  # f, then per pair X, Y, Z, xp, yp: the operand's order
            slots[c] = fv[c][i]
        for q in range(k):
            for c in range(6):
                slots[12 + 8 * q + c] = tv[6 * q + c][i]
            slots[18 + 8 * q], slots[19 + 8 * q] = pv[2 * q][i], pv[2 * q + 1][i]
        for _ in range(count):
            GR.run_body(P, "dbl", slots)
            for q in range(k):
                if valid[q, i]:
                    GR.run_body(P, f"line{q}", slots)
        got = slots[:12] + [slots[12 + 8 * q + c] for q in range(k) for c in range(6)]
        assert got == [want[c][i] for c in range(12 + 6 * k)]
