"""Helpers shared by the ``test_torch_*`` files: carry a reference table
across to the port as plain arrays and strings."""

from __future__ import annotations


def reference_table_arrays(table) -> dict:
    """Keyword arguments of ``repro_torch.convert.table_from_arrays`` that
    rebuild ``table`` (a reference ``TensorTable``) in the port."""
    families = [(f.name, [(c.qualifier, c.shape, c.dtype.str)
                          for c in f.columns])
                for f in table.families.values()]
    columns = {f"{f.name}:{c.qualifier}": table.column(f.name, c.qualifier)
               for f in table.families.values() for c in f.columns}
    policy = table.split_policy
    return dict(
        name=table.name, families=families, rowkeys=table.keys,
        columns=columns,
        region_start_keys=[r.start for r in table.regions],
        region_ids=[r.rid for r in table.regions],
        split_policy=(type(policy).__name__, policy.max_region_bytes))


def port_table(table):
    from repro_torch.convert import table_from_arrays
    return table_from_arrays(**reference_table_arrays(table))
