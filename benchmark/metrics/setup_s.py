"""Seconds from the process's start to the first timed request: imports,
the kernel libraries' load (nvcc on a checkout's first run), the problem
build, canonicalization, the warm-up that captures the cell's step
programs, and a mission cell's cold leg."""


def read(rec):
    return rec["setup_s"]
