"""Host milliseconds a request waits on the device at the program's reads
of device values: the spans ``tracer_torch.sync`` (an escalation's read of
its overflow, the soft ladder's read of phase A's leaf counts), start to
end on the host clock, summed over the root; the median over the traced
roots of each name, summed over the names of a request. 0.0 where the
program read nothing; None for a program without the sync counter."""

from benchmark import program_device as pd


def read(rec):
    return pd.per_request(pd.wait_ms)
