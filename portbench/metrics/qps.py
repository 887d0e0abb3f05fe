"""qps: queries of every batch completed in the window over the window's
host-clock seconds."""


def read(rec):
    w = rec["window"]
    return w["queries"] / w["seconds"]
