"""Communication-cost inspection: count the collectives a program makes.

The counterpart of :func:`xgcm_tpu.utils.count_collectives`.  JAX traces
the function and counts the collective primitives in its jaxpr; eager
PyTorch has no jaxpr, so :func:`count_collectives` runs the function once
with the sharded layer's collective counter
(:data:`xgcm_tpu_torch.parallel.collectives.COLLECTIVES`) reset and
returns what it counted, in the same dict.  The sharded layer makes a
collective wherever the JAX program does, so the two counts agree on the
same program, e.g.::

    n = count_collectives(lambda: sgrid.diff(v, "X") - sgrid.diff(u, "Y"))
    assert n["total"] == 2      # one one-sided ring exchange per diff

Placing operands on the mesh and assembling a global array count 0, as
GSPMD's resharding does not appear in a jaxpr.  A collective in a Python
loop counts once per pass: the count is of one run, not of a trace.

On a mesh over several processes each process counts the collectives it
takes part in, which are all of the program's: every process runs the
same program, so each process's count equals the single-process count
and the jaxpr's, as each JAX process traces the whole program.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

__all__ = ["count_collectives", "COLLECTIVE_PRIMITIVES"]

# substring-matched against the collectives' names
COLLECTIVE_PRIMITIVES = (
    "ppermute",
    "all_gather",
    "all_to_all",
    "psum",
    "reduce_scatter",
    "pmax",
    "pmin",
)


def count_collectives(
    fn: Callable,
    *args,
    names: Sequence[str] = COLLECTIVE_PRIMITIVES,
    **kwargs,
) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and count the collectives it
    made: a dict of per-collective counts plus a ``"total"`` key.
    Collectives are matched by substring against ``names``.  The counter
    is left as it was before the call, plus this run's counts."""
    from ..parallel.collectives import COLLECTIVES

    before = dict(COLLECTIVES)
    COLLECTIVES.clear()
    try:
        fn(*args, **kwargs)
    finally:
        ran = dict(COLLECTIVES)
        COLLECTIVES.clear()
        COLLECTIVES.update(before)
        COLLECTIVES.update(ran)
    counts = {k: v for k, v in ran.items() if any(s in k for s in names)}
    counts["total"] = sum(counts.values())
    return counts
