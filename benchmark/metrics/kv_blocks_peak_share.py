"""The most KV blocks in use (``PagedEngine.hbm_blocks_in_use``: held by a
slot or by the prefix cache) after any step in the window, over the pool's
blocks."""


def read(run):
    c = run.counters
    if not c.get("pool_blocks") or not c.get("blocks_peak"):
        return None
    return c["blocks_peak"] / c["pool_blocks"] * 100
