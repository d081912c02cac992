"""Set-up: from the start of the process to the start of the window
(making and writing the sets, parsing, building, the warm-up unit)."""


def read(run):
    return run.setup_s
