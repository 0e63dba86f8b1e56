"""Device-path compute layers (PyTorch over hand-written CUDA kernels),
batch-first.

  limbs.py      host <-> limb conversion helpers
  kernels.py    nvcc build, ctypes loader, one wrapper per CUDA kernel
  fp.py         Fp/Fr Montgomery arithmetic (+ plain mul/add/sub)
  tower.py      Fp2/Fp6/Fp12 extension towers (+ plain tower, plain pow_win)
  curve.py      G1/G2 Jacobian point ops, scalar ladders, point sums,
                subgroup checks, cofactor (+ plain point kernels, ladders
                and cofactor clearing)
  sha256.py     batched SHA-256
  hash_to_g2.py XMD + hash_to_field + both SSWU maps + isogeny + cofactor
                (+ plain sswu_map2)
  pairing.py    Miller loop + final exponentiation
"""
