"""Host-side python-int helpers of the port: Fp/Fp2 arithmetic (own copy
of the part of the reference package's golden/field.py that the port
needs) and the compressed-point codec (golden/codec.py)."""

from . import field, codec  # noqa: F401
