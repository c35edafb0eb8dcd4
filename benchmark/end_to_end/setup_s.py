"""Seconds from the process start to the first timed call: imports, the
frozen meshes, the model, the warm-up calls and, in a checkout's first
run, the kernel build."""


def read(w):
    return w.setup_s
