"""setup_s: from the process's start to the window's start: imports, the
card, the kernels' build or load, the corpus, the index build and
placement, the warm-up of the cell's shape."""


def read(rec):
    return rec["setup_s"]
