"""setup_s: seconds from the harness's start to the first timed step or
frame: torch and the kernel library (built on a checkout's first run),
the trainer with its scene and pools, the weights, the warm-up."""


def read(rec):
    return rec["setup_s"]
