"""Metric-combination search helper.

Enumerates candidate groupings of axes under which lower-order metrics can be
multiplied into a requested higher-order metric (dx * dy -> area, etc.).
Yield order and contents reproduce reference ``metrics.py:4-30`` so that
``Grid.get_metric``'s find-or-derive resolution behaves identically.
"""

from __future__ import annotations

import itertools
from typing import FrozenSet, Iterable, Iterator, Tuple

__all__ = ["iterate_axis_combinations"]


def iterate_axis_combinations(
    items: Iterable[str],
) -> Iterator[Tuple[FrozenSet[str], ...]]:
    items_set = frozenset(items)
    yield (items_set,)
    n = len(items_set)
    for nleft in range(n - 1, 0, -1):
        nright = n - nleft
        for sub_loop, sub_items in itertools.product(
            range(min(nright, nleft), 0, -1),
            itertools.combinations(items_set, nleft),
        ):
            these = frozenset(sub_items)
            those = items_set - these
            others = [frozenset(i) for i in itertools.combinations(those, sub_loop)]
            yield (these,) + tuple(others)
