"""Host milliseconds a call of the value-and-grad function the fit loop
calls (``ops/siren_kernel.py``'s K1 entry: checks, pointer arrays, the
ctypes launch), from the benchmark's span around it in the traced window."""


def read(run):
    return run["spans"].host_ms_per_call("vag")
