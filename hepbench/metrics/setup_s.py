"""Set-up: process start to the window's start, with loading, weights,
packing, planning (profile, map, fuse), kernel builds and warm-up."""


def read(run):
    return run.setup_s
