"""wait_ms.serve: the host's ms per served call blocked on the device, the
median over the ring's ``detector.infer`` spans of the summed ``sync.*``
spans under each (in serving, the decode's blocking anchor copies,
``sync.decode_anchors``, and NMS's early-exit checks, ``sync.nms_exit``;
the port's utils/tracing). None where the program records no such span."""

import statistics


def read(ctx):
    try:
        from multispectral_object_detection_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = tracing.under("detector.infer", "sync.")
    return statistics.median(ms) if ms else None
