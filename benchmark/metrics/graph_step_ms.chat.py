"""Host time a replayed decode step: the generations' decode seconds
(generate's time after the first token) over their decode steps."""


def read(run):
    chats = [c for c in run.chats if run.t_open <= c[0] < run.t_close]
    steps = sum(c[4] for c in chats)
    return sum(c[3] for c in chats) / steps * 1e3 if steps else None
