"""Process start to the window's start: imports, the weights, the kernels'
libraries (built on a checkout's first run), the fleet, the warm-up call
and the opening fill (s)."""


def read(run):
    return run.setup_s
