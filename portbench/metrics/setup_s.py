"""From the process's start to the window's: imports, the kernels'
libraries, the weights and the warm-up cycle (less the reading of the
program's state that the check takes)."""


def read(run):
    return run.setup_s
