"""Prompt tokens that the window's forwards completed, over the window's
whole time (host clock, from the first batch's making to the last
forward's synchronise)."""


def read(r):
    return r.tokens / r.window_s if r.window_s > 0 else None
