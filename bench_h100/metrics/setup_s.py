"""Set-up: process start to the window's opening (model build, weights
from the seed, kernel loading, the requests' inputs, warm-up)."""


def read(run):
    return run.setup_s
