"""Process start to the start of the first timed round."""


def read(run):
    return run.setup_s
