"""Seconds from the start of the process to the first timed step: data,
weights, the program's build and load, the check's steps and the warm-up."""


def read(run):
    return run.setup_s
