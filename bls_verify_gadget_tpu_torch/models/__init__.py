"""Scheme-level API of the port: batched BLS verify over the torch ops."""

from .bls import BatchedBLS, Params  # noqa: F401
