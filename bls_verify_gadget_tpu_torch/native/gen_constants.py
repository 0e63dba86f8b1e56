"""Generates the host codec's constants.h from the port's constants module
(own copy of the reference package's native/gen_constants.py), so the C++
codec shares one source of truth with the rest of the port.

    python -m bls_verify_gadget_tpu_torch.native.gen_constants DIR
"""

import pathlib
import sys

from .. import constants as C


def limbs64(x, n=6):
    return ", ".join(f"0x{(x >> (64 * i)) & ((1 << 64) - 1):016x}ULL" for i in range(n))


def header() -> str:
    """The text of constants.h."""
    p = C.P
    r64 = 1 << 384
    lines = [
        "// Auto-generated by bls_verify_gadget_tpu_torch/native/gen_constants.py -- do not edit.",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"static const uint64_t FP_P[6] = {{ {limbs64(p)} }};",
        f"static const uint64_t FP_R2[6] = {{ {limbs64(r64 * r64 % p)} }};",
        f"static const uint64_t FP_ONE_MONT[6] = {{ {limbs64(r64 % p)} }};",
        f"static const uint64_t FP_N0 = 0x{(-pow(p, -1, 1 << 64)) % (1 << 64):016x}ULL;",
        f"static const uint64_t ABS_X = 0x{C.ABS_X:016x}ULL;",
        "// (p+1)/4 for sqrt, (p-1)/2 for legendre, big-endian bit use",
        f"static const uint64_t SQRT_EXP[6] = {{ {limbs64((p + 1) // 4)} }};",
        f"static const uint64_t EULER_EXP[6] = {{ {limbs64((p - 1) // 2)} }};",
        "// curve b, Montgomery form",
        f"static const uint64_t B_G1_MONT[6] = {{ {limbs64(C.B_G1 * r64 % p)} }};",
        f"static const uint64_t B_G2_C0_MONT[6] = {{ {limbs64(C.B_G2[0] * r64 % p)} }};",
        f"static const uint64_t B_G2_C1_MONT[6] = {{ {limbs64(C.B_G2[1] * r64 % p)} }};",
        "// G1 GLV beta (Montgomery), psi constants for G2 (Montgomery)",
        f"static const uint64_t BETA_MONT[6] = {{ {limbs64(C.BETA_G1 * r64 % p)} }};",
        f"static const uint64_t PSI_X_C0_MONT[6] = {{ {limbs64(C.PSI_X[0] * r64 % p)} }};",
        f"static const uint64_t PSI_X_C1_MONT[6] = {{ {limbs64(C.PSI_X[1] * r64 % p)} }};",
        f"static const uint64_t PSI_Y_C0_MONT[6] = {{ {limbs64(C.PSI_Y[0] * r64 % p)} }};",
        f"static const uint64_t PSI_Y_C1_MONT[6] = {{ {limbs64(C.PSI_Y[1] * r64 % p)} }};",
        "",
    ]
    return "\n".join(lines)


def emit(directory) -> pathlib.Path:
    """Write constants.h into `directory`; -> its path."""
    out = pathlib.Path(directory) / "constants.h"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(header())
    return out


if __name__ == "__main__":
    print(f"wrote {emit(sys.argv[1])}")
