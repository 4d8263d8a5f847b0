"""upload_host_ms.serve: the host's ms per served call in the upload, the
median over the ring's ``detector.infer`` spans of the summed
``detector.upload`` spans under each (both streams: the pageable copy,
which blocks the host, and the cast; the port's utils/tracing). None
where the program records no such span."""

import statistics


def read(ctx):
    try:
        from multispectral_object_detection_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = tracing.under("detector.infer", "detector.upload")
    return statistics.median(ms) if ms else None
