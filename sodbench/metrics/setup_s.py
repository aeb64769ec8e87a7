"""setup_s: seconds from the process's start to the window's first timed unit."""


def read(name, run):
    return run.setup_s
