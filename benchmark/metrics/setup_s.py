"""setup_s: seconds from the start of run.py to the first timed call:
imports, the card's start, the kernels' build where the checkout has none,
the graph made from the seed, stored and loaded, the cell's preparation
and its warm-up calls."""


def read(run):
    return run.setup_s
