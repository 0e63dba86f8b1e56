"""R1CS constraint system over Fq (381-bit base field).

Rank-1 constraints <A_i, w> * <B_i, w> = <C_i, w> with w the full assignment
vector (w[0] = 1, then instance variables, then witness variables).

This plays the role of ark-relations' ConstraintSystem
(reference src/constraints.rs:8, src/hasher.rs:20): allocation modes,
constraint accounting (`num_constraints`, printed by the reference's tests at
src/constraints.rs:372), satisfiability checking — plus export to flat numpy
arrays for the batched device evaluator (evaluator.py).
"""

import enum

from ..constants import P


class AllocationMode(enum.Enum):
    """Reference AllocationMode (constant / input / witness),
    src/constraints.rs:194-249 usage."""

    CONSTANT = 0
    INPUT = 1
    WITNESS = 2


class ConstraintSystem:
    def __init__(self, field_mod: int = P):
        self.field_mod = field_mod
        self.assignments = [1]  # index 0 is the constant ONE
        self.is_instance = [True]
        self.a_rows: list = []
        self.b_rows: list = []
        self.c_rows: list = []
        self.names: list = []
        # (aux var index, constraint row index) pairs appended by LC-width
        # capping — exported by to_arrays so device-side witness generation
        # can materialise the partial sums (evaluator.complete_witness)
        self.aux_splits: list = []
        # witness-generation tape: every allocation site records how its
        # witnesses derive from earlier variables, so r1cs/witness_vm.py can
        # replay the whole assignment batch-parallel on device.  Entries:
        # {"kind": str, "outs": [var...], "lcs": [lc...], "meta": ...}
        self.tape: list = []
        self._tape_suppress = 0

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    @property
    def num_vars(self) -> int:
        return len(self.assignments)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_instance_vars(self) -> int:
        return sum(self.is_instance)

    @property
    def num_witness_vars(self) -> int:
        return len(self.assignments) - self.num_instance_vars

    def new_variable(self, value: int, mode: AllocationMode = AllocationMode.WITNESS) -> int:
        assert mode != AllocationMode.CONSTANT, "constants are LC terms, not variables"
        idx = len(self.assignments)
        self.assignments.append(value % self.field_mod)
        self.is_instance.append(mode == AllocationMode.INPUT)
        return idx

    def new_witness(self, value: int) -> int:
        return self.new_variable(value, AllocationMode.WITNESS)

    def new_input(self, value: int) -> int:
        return self.new_variable(value, AllocationMode.INPUT)

    # ------------------------------------------------------------------
    # witness-generation tape (device replay; r1cs/witness_vm.py)
    # ------------------------------------------------------------------

    def record(self, kind: str, outs, lcs, meta=None):
        """Record how witness vars `outs` derive from LCs over earlier
        vars.  No-op inside a suppress() block (a parent op records a
        single higher-level entry for its internal allocations)."""
        if self._tape_suppress == 0:
            self.tape.append(
                {"kind": kind, "outs": list(outs), "lcs": [list(l) for l in lcs],
                 "meta": meta}
            )

    class _Suppress:
        def __init__(self, cs):
            self.cs = cs

        def __enter__(self):
            self.cs._tape_suppress += 1

        def __exit__(self, *exc):
            self.cs._tape_suppress -= 1
            return False

    def suppress_tape(self):
        return ConstraintSystem._Suppress(self)

    def tape_uncovered(self):
        """Variable indices (excluding 0) not produced by any tape entry —
        these must be supplied as inputs to the witness VM."""
        covered = set()
        for e in self.tape:
            covered.update(e["outs"])
        return [
            i for i in range(1, len(self.assignments)) if i not in covered
        ]

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------

    def enforce(self, a_lc, b_lc, c_lc, name: str = ""):
        """a_lc/b_lc/c_lc: list[(var_idx, coeff)]."""
        self.a_rows.append(list(a_lc))
        self.b_rows.append(list(b_lc))
        self.c_rows.append(list(c_lc))
        if name:
            self.names.append((len(self.a_rows) - 1, name))

    def lc_value(self, lc) -> int:
        m = self.field_mod
        return sum(self.assignments[i] * c for i, c in lc) % m

    def is_satisfied(self) -> bool:
        return self.which_unsatisfied() is None

    def which_unsatisfied(self):
        """Index of the first failing constraint, or None (host check;
        the batched device check lives in evaluator.py)."""
        m = self.field_mod
        for i, (a, b, c) in enumerate(zip(self.a_rows, self.b_rows, self.c_rows)):
            if self.lc_value(a) * self.lc_value(b) % m != self.lc_value(c):
                return i
        return None

    # ------------------------------------------------------------------
    # export for the device evaluator
    # ------------------------------------------------------------------

    def to_arrays(self, row_width: int = 8):
        """Flatten A/B/C into fixed-width padded index/coeff arrays:
        returns dict with 'a_idx','a_coeff',... each (n_constraints,
        row_width).  Rows longer than row_width are split by introducing
        auxiliary partial-sum variables bound by extra constraints."""
        import numpy as np

        self._cap_row_widths(row_width)
        n = self.num_constraints

        def pack(rows):
            idx = np.zeros((n, row_width), np.int32)
            coeff = np.zeros((n, row_width), object)
            for i, row in enumerate(rows):
                for j, (v, co) in enumerate(row):
                    idx[i, j] = v
                    coeff[i, j] = co % self.field_mod
            return idx, coeff

        ai, ac = pack(self.a_rows)
        bi, bc = pack(self.b_rows)
        ci, cc = pack(self.c_rows)
        return {
            "a_idx": ai, "a_coeff": ac,
            "b_idx": bi, "b_coeff": bc,
            "c_idx": ci, "c_coeff": cc,
            "num_vars": self.num_vars,
            # LC-split partial-sum variables, in append order; a split row's
            # tail may reference LATER-appended aux vars, so consumers
            # materialise them in REVERSE order (evaluator.complete_witness)
            "aux_var": np.asarray([s for s, _ in self.aux_splits], np.int32),
            "aux_row": np.asarray([r for _, r in self.aux_splits], np.int32),
        }

    def _cap_row_widths(self, row_width: int):
        """Split any LC longer than row_width using auxiliary variables
        s = partial sum, bound by an extra constraint tail * 1 = s.  Newly
        appended rows are themselves revisited (the loop bound re-reads
        len())."""
        i = 0
        while i < len(self.a_rows):
            for rows in (self.a_rows, self.b_rows, self.c_rows):
                while len(rows[i]) > row_width:
                    head, tail = rows[i][: row_width - 1], rows[i][row_width - 1 :]
                    s = self.new_witness(self.lc_value(tail))
                    self.a_rows.append(list(tail))
                    self.b_rows.append([(0, 1)])
                    self.c_rows.append([(s, 1)])
                    self.aux_splits.append((s, len(self.a_rows) - 1))
                    rows[i] = head + [(s, 1)]
            i += 1
