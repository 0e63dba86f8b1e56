"""bls_verify_gadget_tpu_torch: the PyTorch/CUDA port of bls_verify_gadget_tpu.

Batched BLS12-381 signature verification, keygen, signing and
aggregation (ETH2 ciphersuite) on an NVIDIA Hopper card.  The field
arithmetic, the pairing's Miller runs and exp-by-x chains, the hash map and
cofactor clearing, the subgroup and scalar ladders, the point additions
and the Fermat inverse run through hand-written CUDA C++ kernels (csrc/,
built with nvcc on first use and loaded with ctypes); the glue between
them is plain PyTorch.  parallel/ shards the scheme over ranks with
torch.distributed, and native_codec.py decodes wire bytes in C++ on the
host (built with g++ on first use).
Every tensor entry point runs on `cuda` unless the caller passes
device="cpu", where each kernel's plain PyTorch version runs instead.

The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
