"""Process start to the first timed request: imports, inputs, the program's
build and load, and its warm-up."""


def read(run):
    return run.setup_s
