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


# ----------------------------------------------------------------------
# several ranks on the CPU (gloo), for the sharded step's tests
# ----------------------------------------------------------------------

def _rank_main(rank, world, store_path, target, args, queue):
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        queue.put((rank, "ready", None))
        queue.put((rank, "ok", target(rank, *args)))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


#: seconds from the spawn until every rank has joined the group: four
#: interpreters starting, importing torch and the test module, and the
#: gloo rendezvous, under the whole suite's load
JOIN_TIMEOUT = 240.0


def run_ranks(target, world: int, tmp_path, timeout: float, *args):
    """``target(rank, *args)`` in ``world`` spawned processes joined in one
    gloo group (a ``FileStore`` under ``tmp_path``, one intra-op thread
    each) -> the results by rank.  A rank that fails, ranks that have not
    all joined the group ``JOIN_TIMEOUT`` seconds after the spawn, or a
    run that outlasts ``timeout`` seconds from the moment the last rank
    joined, fail the caller: the run's clock starts at the rendezvous, so
    a slow start under load does not eat into it."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, target, args, q))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    joined, out, t_joined = set(), {}, None
    try:
        while len(out) < world:
            if t_joined is None:
                left = JOIN_TIMEOUT - (time.monotonic() - t0)
                late = f"ranks did not join the group in {JOIN_TIMEOUT} s"
            else:
                left = timeout - (time.monotonic() - t_joined)
                late = (f"ranks did not finish in {timeout} s after "
                        f"joining the group")
            try:
                rank, status, value = q.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                raise AssertionError(late) from None
            if status == "error":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            if status == "ready":
                joined.add(rank)
                if len(joined) == world:
                    t_joined = time.monotonic()
            else:
                out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return out
