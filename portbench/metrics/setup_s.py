"""setup_s: from the process's start to the window: imports, the kernels'
build (the first run of a checkout), the scan made on the card, the open,
the session's set-up and the warm-up steps."""


def read(run):
    return run.setup_s
