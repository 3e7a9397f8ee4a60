"""Process start to the first timed request: torch, the CUDA context, the
entry's inputs made from the seed, the Viterbi kernel's load (its build in
a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
