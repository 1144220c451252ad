"""Periodic-column combinators, the sub-AIR composition toolkit: a copy of
certificate_stark_tpu/utils/periodic.py (the reference's
src/utils/periodic_columns.rs: stitch/fill/pad, which assemble the composed
AIR's 48 mask/ARK columns in src/air.rs:194-379).

The port's composed AIR builds its columns directly (models/transaction.py);
the combinators make new compositions convenient. Host code: columns are
Python lists of ints, and each function updates `columns` in place and
returns it.
"""
from __future__ import annotations


def stitch(columns: list, new_columns: list, index_map: list) -> list:
    """Append `new_columns[src]` to `columns[dst]` for each (src, dst) pair
    (reference periodic_columns.rs:54-121)."""
    for src, dst in index_map:
        columns[dst] = list(columns[dst]) + list(new_columns[src])
    return columns


def fill(columns: list, patterns: list, index_map: list, length: int) -> list:
    """Extend `columns[dst]` with repetitions of `patterns[src]` until it
    reaches `length` (reference periodic_columns.rs:124-186)."""
    for src, dst in index_map:
        pat = list(patterns[src])
        col = list(columns[dst])
        while len(col) < length:
            col.extend(pat[:length - len(col)])
        columns[dst] = col
    return columns


def pad(columns: list, indices: list, length: int, value) -> list:
    """Extend each `columns[i]` with `value` up to `length`
    (reference periodic_columns.rs:189-214)."""
    for i in indices:
        col = list(columns[i])
        if len(col) < length:
            col.extend([value] * (length - len(col)))
        columns[i] = col
    return columns
