"""Wall time of the whole window (ms) over all models completed in it."""


def read(w):
    return w.window_s * 1e3 / w.models if w.models else None
