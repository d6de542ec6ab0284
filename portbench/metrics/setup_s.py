"""setup_s: seconds from the process's start to the window's start
(imports, the kernels' load or build, initialize, the state pool, the
key's eager and capturing warm-up calls)."""


def read(run):
    return run.setup_s
