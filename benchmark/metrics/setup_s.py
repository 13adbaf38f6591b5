"""From the process's start to the window's first frame: imports, CUDA
initialisation, loading (on a checkout's first run, building) the
kernels, the route's render on the card, the captures and the warm-up."""


def read(run):
    return run.setup_s
