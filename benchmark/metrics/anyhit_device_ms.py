"""Device milliseconds a profiled request in the any-hit (shadow) walk:
the operations whose name holds ``AnyhitWalk``
(``leafwalk::walk_items<AnyhitWalk>``). None where no such kernel ran."""

from benchmark import readers

ANYHIT = ("AnyhitWalk",)


def read(rec):
    return readers.device_ms(rec, ANYHIT)
