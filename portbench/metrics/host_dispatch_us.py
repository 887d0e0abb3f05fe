"""host_dispatch_us: the benchmark's host span from the call into the
program until it returns, before the batch is waited for; the mean over
the window's batches (the traced run's window, outside the profiler)."""


def read(rec):
    spans = rec["window"]["host_call_s"]
    return 1e6 * sum(spans) / len(spans) if spans else None
