"""block_scan_roofline: the full scan's frozen bound
(``counts.exhaustive_bound``) over the device time of a traced batch's
call, the output's zero fill included, in %."""

from portbench.counts import exhaustive_bound
from portbench.trace import kernel_seconds

SCAN_KERNEL = r"block_scan_(resident_)?kernel"


def read(rec):
    tr, mix = rec.get("trace"), rec["mix"]
    if not tr or mix.get("kind") != "block_scan" or kernel_seconds(tr, SCAN_KERNEL) <= 0:
        return None
    t = tr["device_s"] / tr["batches"]
    return 100 * exhaustive_bound(rec["stats"], rec["window"]["batch"]) / t
