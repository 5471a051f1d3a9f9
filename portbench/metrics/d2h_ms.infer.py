"""Device milliseconds a request spends copying its result to the host:
the traced window's device-to-host copies over its requests."""


def read(run):
    trace, n = run.get("trace"), len(run["window"].get("latencies_ms") or ())
    s = trace.copy_s("DtoH") if trace is not None else None
    return 1e3 * s / n if s and n else None
