"""Wall time of the whole window (ms) over all drive points completed in it."""


def read(w):
    return w.window_s * 1e3 / w.points if w.points else None
