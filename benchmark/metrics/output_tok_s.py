"""Every output token the program delivered inside the window, over the
window's seconds (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.tokens_in_window() / run.window_s
