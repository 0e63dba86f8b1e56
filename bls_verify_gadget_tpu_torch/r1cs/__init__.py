"""R1CS constraint/witness layer over the BLS12-381 base field Fq (the
port's copy of the JAX package's r1cs/; the builders build the same
circuit: the same assignments, tape and to_arrays() output).

All circuit variables live in Fq = Fp (the 381-bit base field), so every
Fp/Fp2 curve operation in-circuit is native field arithmetic
(reference src/hasher.rs:32, src/constraints.rs:18).

Host builders (python ints, no tensors):
  system.py          ConstraintSystem: allocation, sparse A/B/C rows,
                     accounting, the witness-generation tape
  gadgets.py         FpVar / Boolean / UInt8 / UInt32 vocabulary
  fields.py          Fp2Var tower gadgets, Fp6/Fp12 inverses
  curve.py           G1Var/G2Var affine point gadgets
  sha256.py          in-circuit SHA-256 (Sha256Gadget parity)
  hasher.py          in-circuit hash-to-G2 (DefaultFieldHasherWithCons parity)
  pairing.py         in-circuit Miller loop + final exponentiation
  verify.py          BlsSignatureVerifyGadget: verify / aggregate_verify
Device side (torch; the lc_dot kernel, ops/kernels.py):
  evaluator.py       batched <A,w>*<B,w>=<C,w> checking, aux completion
  witness_vm.py      batch-parallel replay of the witness tape
  device_witness.py  the SHA-256 / XMD gadgets' witness from the messages
"""

from .system import ConstraintSystem, AllocationMode  # noqa: F401
