"""Substrings of the hand-written kernels' symbol names, by group.

The split walks are ``leafwalk::walk_items<ClosestWalk<GridRows>>`` (the leaf
walk), ``<ClosestWalk<PairRows>>`` (the routed walk), ``<AnyhitWalk>`` and
``tilewalk::walk_items<TileWalk>``, each followed by
``leafwalk::unpack_kernel`` where it returns t; the packet walk's two
launches are ``walk_kernel<LS>`` and ``resume_kernel<K, LS>``; the row
compactor is ``compact_rows``. A device operation belongs to a group when
its name contains any of the group's substrings.
"""

WALK = ("ClosestWalk", "PairRows", "AnyhitWalk", "TileWalk", "walk_kernel",
        "resume_kernel", "leafwalk::unpack_kernel")
COMPACT = ("compact_rows",)


def in_group(name: str, group) -> bool:
    return any(s in name for s in group)
