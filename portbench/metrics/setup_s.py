"""Host seconds from the start of the process to the first timed chunk:
imports, CUDA start-up, the kernel library, inputs from the seed (the
archive and its index included), detector banks and the warm-up."""


def read(t):
    return t.setup_s
