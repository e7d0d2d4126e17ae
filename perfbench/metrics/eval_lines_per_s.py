"""Lines evaluated in the window (loss, decode, meters), over its seconds."""


def read(rec):
    return rec.lines / rec.window_s if rec.mode == "eval" and rec.window_s else None
