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


def port_model_config(cfg):
    """The port's ``ModelConfig`` with the same fields as a reference one
    (jnp dtypes become torch dtypes)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import config as C

    dtypes = {np.dtype("float32"): torch.float32,
              np.dtype("bfloat16"): torch.bfloat16,
              np.dtype("float16"): torch.float16}
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            v = dtypes[np.dtype(v)]
        elif dataclasses.is_dataclass(v):
            v = getattr(C, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return C.ModelConfig(**kw)
