"""viewpoints_per_s: viewpoints (frames or observers) of the requests
completed in the window, over the whole window."""


def read(w):
    return w.viewpoints / w.window_s
