"""One driver per traffic kind, found by the ``kind`` of a traffic file.

A driver module has ``setup(config, traffic, seed, device) -> state``,
``warmup(state)``, ``request(state, spans) -> fn(n) -> (work, failed,
outputs)``, ``release(state, kept) -> kept`` (maps the kept outputs to what
the check reads and drops the program's state), and ``check(state, kept,
control) -> readings``.
"""
