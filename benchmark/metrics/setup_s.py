"""Seconds from the process's start to the first timed request: imports,
the inputs, the trees and tables, the first build of the kernels in a
new checkout, and the warm-up."""


def read(rec):
    return rec["setup_s"]
