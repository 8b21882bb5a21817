"""Seconds from the process's start to the window's first call: imports,
the kernel library, the fixture, the weights, the inputs and the warm-up."""


def read(m):
    return m.setup_s
