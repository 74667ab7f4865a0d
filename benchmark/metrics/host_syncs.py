"""Host syncs a request makes inside the program: the counter ``syncs``
(one a warning of torch's CUDA sync debug mode while a root is open)
summed over every span of the root, the reads of the ``tracer_torch.sync``
spans and any sync made elsewhere; the median over the traced roots of
each name, summed over the names of a request. None for a program
without the counter."""

from benchmark import program_device as pd


def read(rec):
    return pd.per_request(pd.syncs)
