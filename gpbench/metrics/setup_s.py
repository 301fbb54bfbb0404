"""setup_s: seconds from the process's start to the measured window's
start (imports, the kernel library from its build directory, the warm-up
job at the cell's shapes)."""


def read(run):
    return run.setup_s
