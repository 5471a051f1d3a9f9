"""Seconds from the start of the process until the window opens: imports,
the CUDA context, kernel builds (the first run in a checkout) or loads,
the seeded inputs, the program's preparation and its warm-up."""


def read(run):
    return run["setup_s"]
