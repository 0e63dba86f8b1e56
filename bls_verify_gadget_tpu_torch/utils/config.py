"""Runtime configuration of the port (counterpart of the JAX package's
utils/config.py): which form of the pairing runs, and whether verify
checks subgroups.

The flags keep the JAX package's names and meanings and default to True,
the JAX package's default configuration.  fuse_miller and fuse_expx off
run the JAX package's step-wise pairing forms on the thin tower kernels
(ops/pairing.py); check_subgroups off skips verify's subgroup checks.  The
port reads no environment variable; a caller sets the fields and restores
them.  The JAX package's other flags are its TPU's own fusion and tiling
knobs (use_pallas, pallas_tile, the fuse_* kernels, cios_v3,
static_ladders) and its jit signature's msg_len: the port always runs its
hand-written kernels, the static run-structured ladders and one Montgomery
core, and takes msg_len per call."""

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
    # verify's subgroup checks of pk (G1) and sig (G2), the three
    # pt_mul_const ladders.  Off: on-curve and identity checks only, for
    # callers that check their inputs beforehand (models/bls.py
    # _point_checks).
    check_subgroups: bool = True


config = Config()
