"""The numbers that decide ``correct``, each a gap between what the program
produced and what the reference works out for the same inputs."""
from __future__ import annotations

import statistics


def loss_gap(prog: list, ref: list) -> float:
    """Largest relative gap of the steps' losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_norm_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    names = sorted(leaves if leaves is not None else ref)
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    return {n: abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med)
            for n in names}


def leaf_norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's ``leaf_norm_gaps``."""
    return max(leaf_norm_gaps(prog, ref, leaves).values())


def moving_leaves(grad: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is more than ``share`` of the median
    leaf's (the others move under Adam by rounding alone)."""
    norms = {n: float(g.double().norm()) for n, g in grad.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v > share * med]


def change(after: dict, before: dict) -> dict:
    return {n: after[n].double() - before[n].double() for n in after}
