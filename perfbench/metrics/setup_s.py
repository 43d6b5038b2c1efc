"""Set-up: from the start of the process to the opening of the window
(CUDA, weights made on the card, kernels loaded, shapes warmed, a closed
loop's slots filled)."""


def read(run, ctx):
    return run["setup_s"]
