"""setup_s: from the process's start to the measured window: imports, the
card's context, the kernels' build or load, the parameters drawn, the
controller planned and its LSTM fitted, and the warm-up steps."""


def read(r):
    return r.setup_s
