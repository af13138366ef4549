"""The traffic generator: determined by the seed, the same sizes for every
seed (another order), and the distributions the mix files state."""

import statistics

import pytest

import tiny_cells  # noqa: F401  (puts the repository on the path)
from benchmark.traffic import generator as G

MIXES = ("chat-paged", "batch16", "chat-scan")
IDS = (3, 32000)


def take(mix, seed, n):
    it = G.stream(mix, IDS, seed)
    return [next(it) for _ in range(n)]


def key(s):
    return (s.prompt, s.max_new, s.due, s.seed, s.temperature, s.top_p, s.prefix)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = G.load_mix(name)
    a, b = take(mix, 2 ** 31 + 77, 48), take(mix, 2 ** 31 + 77, 48)
    assert [key(s) for s in a] == [key(s) for s in b]
    assert [key(s) for s in a] != [key(s) for s in take(mix, 5, 48)]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_work(name):
    mix = G.load_mix(name)
    a, b = take(mix, 1, 4 * mix["block"]), take(mix, 2 ** 33 + 2, 4 * mix["block"])
    shape = lambda s: (len(s.prompt), s.max_new, s.due, s.prefix, s.greedy)  # noqa: E731
    assert [shape(s) for s in a] == [shape(s) for s in b]
    assert [s.prompt for s in a] != [s.prompt for s in b]
    assert [s.seed for s in a] != [s.seed for s in b]
    # a block's sizes are its quantiles in an order of their own
    G_ = mix["block"]
    assert sorted(s.max_new for s in a[:G_]) != [s.max_new for s in a[:G_]]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = dict(G.load_mix(name), prefix=None)
    specs = take(mix, 3, 64 * mix["block"])
    for what, sizes in (("prompt", [len(s.prompt) for s in specs]),
                        ("output", [s.max_new for s in specs])):
        dist = mix[what]
        assert min(sizes) >= dist["min"] and max(sizes) <= dist["max"]
        med = statistics.median(sizes)
        assert abs(med - dist["median"]) <= 0.03 * dist["median"], (what, med)
        # the log-normal's spread: its 84th percentile sits one sigma above
        p84 = sorted(sizes)[int(0.8413 * len(sizes))]
        want = min(dist["max"], dist["median"] * 2.718281828 ** dist["sigma"])
        assert abs(p84 - want) <= 0.06 * want, (what, p84, want)


def test_open_loop_rate_and_shares():
    mix = G.load_mix("chat-paged")
    specs = take(mix, 2 ** 32 + 3, 64 * mix["block"])
    rate = (len(specs) - 1) / (specs[-1].due - specs[0].due)
    assert abs(rate - mix["rate_per_s"]) <= 0.02 * mix["rate_per_s"]
    G_ = mix["block"]
    systems = {}
    for blk in range(0, len(specs), G_):
        b = specs[blk:blk + G_]
        assert sum(s.prefix >= 0 for s in b) == round(mix["prefix"]["share"] * G_)
        assert sum(s.greedy for s in b) == round(mix["sampling"]["greedy_share"] * G_)
        for s in b:
            if s.prefix >= 0:
                head = tuple(s.prompt[:mix["prefix"]["tokens"]])
                assert systems.setdefault(s.prefix, head) == head
                assert len(s.prompt) >= mix["prefix"]["tokens"] + G.PREFIX_OWN_MIN
            if not s.greedy:
                assert (s.temperature, s.top_p) == (0.7, 0.95)
    assert len(systems) == mix["prefix"]["count"]


def test_token_ids_stay_in_range():
    for name in MIXES:
        for s in take(G.load_mix(name), 2 ** 31 + 1, 32):
            assert all(IDS[0] <= t < IDS[1] for t in s.prompt)
