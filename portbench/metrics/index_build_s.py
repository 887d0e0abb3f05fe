"""index_build_s: the benchmark's host span around the program's build
calls (the host build from the CSR and the placement on the device, up
to a synchronize)."""


def read(rec):
    return rec["spans"].get("index_build_s")
