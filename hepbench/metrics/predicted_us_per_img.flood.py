"""Mapper: the served configuration's expected time per example."""


def read(run):
    return run.served.expected_time_per_example * 1e6
