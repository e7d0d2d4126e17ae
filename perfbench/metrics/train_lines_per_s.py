"""Lines of every train step completed in the window, over its seconds."""


def read(rec):
    return rec.lines / rec.window_s if rec.mode == "train" and rec.window_s else None
