"""Tiny stand-ins for the cells' models, of the same family and
structural flags, and short prompts arriving fast, for runs on the
CPU.  The sizes are the family adapter's ``TINY``."""

import copy

from colobench.lib import cells, model


def tiny_cell(name: str, dtype: str = None, points: int = 4):
    """The cell ``name`` with its model cut to its family's tiny widths
    and its traffic to ``points`` short prompt lengths arriving fast."""
    cell = copy.deepcopy(cells.load(name))
    fam = model.family(cell.config)
    if not hasattr(fam, "TINY"):
        raise AttributeError(f"{fam.__file__} has no TINY: the sizes of "
                             f"the CPU tests' stand-in of its family")
    cell.config.update(copy.deepcopy(fam.TINY))
    if dtype:
        cell.config["dtype"] = dtype
        cell.config["param_dtype"] = dtype
    cell.traffic["lengths"].update(median=24, sigma=0.4, min=8, max=64,
                                   points=points, multiple=8)
    cell.traffic["arrivals"]["rate_per_s"] = 200.0
    cell.traffic["check_requests"] = 3
    return cell
