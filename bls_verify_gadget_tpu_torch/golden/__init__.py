"""Host-side python-int oracle and host scheme of the port (own copies of
the reference package's golden/ modules): the field tower (field), the
curve groups with their subgroup checks (curve), hash-to-G2
(hash_to_curve), the pairing (pairing), the compressed-point codec
(codec) and the scheme API with its key, point and GT codecs (bls)."""

from . import field, codec  # noqa: F401
