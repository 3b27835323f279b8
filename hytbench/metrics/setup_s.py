"""setup_s (end to end, host clock): from the start of the process to the
first timed run: imports, the kernels loaded (built, in a checkout's first
run), the graph drawn, the program's preprocessing and the warm-up run."""


def read(obs):
    return obs.setup_s
