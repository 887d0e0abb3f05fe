"""rows_dot_roofline: the flat engine's rows kernel, which scores every
document for every query of the batch: the frozen bound
(``counts.exhaustive_bound``) over the kernel's device time a traced
batch, in %."""

from portbench.counts import exhaustive_bound
from portbench.trace import kernel_seconds

ROWS_KERNEL = r"rows_dot_(shared_|warp_)?kernel"


def read(rec):
    tr, mix = rec.get("trace"), rec["mix"]
    if not tr or mix.get("kind") != "retriever" or mix.get("engine") != "flat":
        return None
    t = kernel_seconds(tr, ROWS_KERNEL) / tr["batches"]
    if t <= 0:
        return None
    return 100 * exhaustive_bound(rec["stats"], rec["window"]["batch"]) / t
