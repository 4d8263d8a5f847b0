"""nms_wait_ms.eval: the host's ms per image blocked in NMS's early-exit
checks, the median over the ring's ``eval.batch`` spans of the summed
``sync.nms_exit`` spans under each, over the mix's batch size (the port's
utils/tracing). None where the program records no such span."""

import statistics


def read(ctx):
    try:
        from multispectral_object_detection_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = tracing.under("eval.batch", "sync.nms_exit")
    return statistics.median(ms) / ctx["traffic"]["batch"] if ms else None
