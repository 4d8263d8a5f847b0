"""msda_ms.detr: device ms per traced call of every kernel launched under
the program's ``msda`` spans (ops/msda), from a trace that records the
host's operators, so that each kernel is counted under the
``record_function`` range its launch ran in, whatever implements the
sampling (the driver's ``span_device_ms``). None where the program opens
no such span."""


def read(ctx):
    return (ctx.get("span_ms") or {}).get("msda")
