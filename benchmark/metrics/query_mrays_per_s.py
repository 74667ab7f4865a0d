"""Rays whose (t, slot) came back from queries that did not overflow, in
millions, over the window's seconds."""


def read(rec):
    w = rec["window"]
    return w["work"] / w["seconds"] / 1e6
