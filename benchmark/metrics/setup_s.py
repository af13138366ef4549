"""Process start to the window's opening: imports, the kernels' build or
load, the weights drawn on the card, the warm-up of the cell's shapes and
the ramp of its traffic."""


def read(run):
    return run.setup_s
