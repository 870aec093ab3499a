"""From the process's start to the first timed query: CUDA init, the
graph made, the program's first call and the warm-up."""


def read(rec):
    return rec.setup["setup_s"]
