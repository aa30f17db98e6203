"""Runtime-registerable lookup tables (the port's copy of the JAX package's
`arithmetization/lookup_table.py`, host only).

`arithmetization/plonk/lookup_table_definition.hpp:39-349`: named table
definitions with subtables (column subsets over row ranges), a `generate()`
hook filling the table rows, and the packer that lays all registered tables
into the assignment table's constant columns with tag selectors, producing
the `plonk_lookup_table` objects consumed by the lookup argument.
"""
from __future__ import annotations

import dataclasses

from . import plonk as PK


@dataclasses.dataclass
class SubtableDefinition:
    """Column subset + row range of the parent table."""
    column_indices: list[int]
    begin: int
    end: int                      # inclusive


class LookupTableDefinition:
    """Subclass and implement generate() to fill `table` (list of columns)."""

    def __init__(self, name: str):
        self.name = name
        self.table: list[list[int]] = []
        self.subtables: dict[str, SubtableDefinition] = {}

    def generate(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def get_table(self) -> list[list[int]]:
        if not self.table:
            self.generate()
        return self.table


class FilledLookupTableDefinition(LookupTableDefinition):
    def __init__(self, name: str, table: list[list[int]],
                 subtables: dict[str, SubtableDefinition] | None = None):
        super().__init__(name)
        self.table = table
        self.subtables = subtables or {
            "full": SubtableDefinition(list(range(len(table))), 0,
                                       (len(table[0]) - 1) if table else 0)
        }

    def generate(self):
        pass


def pack_lookup_tables(
        definitions: list[LookupTableDefinition],
        usable_subtables: dict[str, list[str]],
        constant_cols_offset: int,
        selector_cols_offset: int,
        start_row: int = 1,
) -> tuple[list[PK.LookupTable], list[list[int]], list[list[int]], int]:
    """Lay the usable subtables of the registered definitions into fresh
    constant columns (data) + selector columns (tags), returning
    (lookup_tables, constant_columns, selector_columns, rows_used).

    Layout rule (as in the reference packer): each subtable option is a
    rectangle of constant columns over contiguous rows, tagged by its own
    selector; tables are stacked vertically starting at `start_row` (row 0
    stays empty so the compressed value column begins with a zero — the
    sorting algorithm's precondition)."""
    lookup_tables: list[PK.LookupTable] = []
    constant_cols: list[list[int]] = []
    selector_cols: list[list[int]] = []
    row = start_row

    for definition in definitions:
        if definition.name not in usable_subtables:
            continue
        table = definition.get_table()
        for sub_name in usable_subtables[definition.name]:
            sub = definition.subtables[sub_name]
            width = len(sub.column_indices)
            nrows = sub.end - sub.begin + 1
            # allocate fresh constant columns for this option
            col_base = constant_cols_offset + len(constant_cols)
            for ci in sub.column_indices:
                col = [0] * row + table[ci][sub.begin:sub.end + 1]
                constant_cols.append(col)
            sel_index = selector_cols_offset + len(selector_cols)
            sel = [0] * row + [1] * nrows
            selector_cols.append(sel)
            lt = PK.LookupTable(tag_index=sel_index, columns_number=width)
            lt.append_option([PK.Var(col_base + k, 0, PK.CONSTANT)
                              for k in range(width)])
            lookup_tables.append(lt)
            row = max(row, row + 0)  # options are parallel per table region
        row += max((definition.subtables[s].end
                    - definition.subtables[s].begin + 1
                    for s in usable_subtables[definition.name]), default=0)

    max_len = max((len(c) for c in constant_cols + selector_cols), default=0)
    constant_cols = [c + [0] * (max_len - len(c)) for c in constant_cols]
    selector_cols = [c + [0] * (max_len - len(c)) for c in selector_cols]
    return lookup_tables, constant_cols, selector_cols, max_len
