"""launch_ms.serve: the host's ms to enqueue the model per served call, the
median over the ring's ``detector.infer`` spans (the window's calls decide
it) of the ``model.forward`` span under each (the port's utils/tracing).
None where the program records no such span."""

import statistics


def read(ctx):
    try:
        from multispectral_object_detection_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = tracing.under("detector.infer", "model.forward")
    return statistics.median(ms) if ms else None
