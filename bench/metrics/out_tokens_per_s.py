"""Requested output tokens of the requests the window finished, over the
window's seconds (host clock).  Padding rows and tokens decoded past a
request's own τout are not counted."""


def read(run):
    return run.out_tokens() / run.window_s
