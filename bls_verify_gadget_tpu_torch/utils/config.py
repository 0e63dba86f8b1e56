"""Runtime configuration of the port (counterpart of the JAX package's
utils/config.py): which form of the pairing runs.

Both flags keep the JAX package's names and meanings and default to True,
the JAX package's default configuration.  Off, the pairing runs the JAX
package's step-wise forms on the thin tower kernels (ops/pairing.py).  The
port reads no environment variable; a caller sets the fields and restores
them.  Its other flags are not ported: the port always runs the static
run-structured ladders and one Montgomery core."""

import dataclasses


@dataclasses.dataclass
class Config:
    # The Miller loop as one miller_dbl_run launch per doubling run of |x|
    # and one miller_add launch per set bit.  Off: per doubling one
    # fp12_sqr, one dbl_step over every pair and one mul014 per pair; per
    # set bit one add_step and one mul014 per pair.
    fuse_miller: bool = True
    # Each exp-by-|x| chain of the final exponentiation as ONE exp_x
    # launch.  Off: one cyclo_sqr launch per run of |x| and one fp12_mul
    # per set bit.
    fuse_expx: bool = True


config = Config()
