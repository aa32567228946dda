"""setup_s (s): the process's start to the window's open (host clock)."""


def read(ctx):
    return ctx["setup_s"]
