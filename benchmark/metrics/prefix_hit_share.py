"""Prompt tokens served from the prefix cache: ``PrefixCache.hits`` (blocks
reused at admission) gained in the window, times the block size, over the
prompt tokens (BOS included) of the requests admitted in the window."""


def read(run):
    c = run.counters
    if not c.get("prompt_tokens") or "hits_close" not in c:
        return None
    return (c["hits_close"] - c["hits_open"]) * c["block_size"] / c["prompt_tokens"] * 100
