"""device_mem_gib: the device memory the process held over the window,
``max_memory_reserved`` with its peak reset at the window's start after
the set-up's freed blocks were released: the index, the plans' CUDA
graph pools (whose blocks ``max_memory_allocated`` counts as free once
captured, though no other allocation may take them), the workspace and
the batch in flight."""


def read(rec):
    b = rec.get("device_mem_window_bytes")
    return b / 2**30 if b else None
