"""A numpy transcription of the column medians' warp radix select
(``csrc/medians.cu``: ``warp_radix_select``, ``column_median``) against
np.median, the plain version ``col_medians_plain`` and the JAX Pallas kernel
(``pallas_masked_medians_rowcol``, interpret mode).

The transcription keeps the kernel's structure: row r of a column is lane
r % 32, slot r // 32; a first pass takes the column's least and largest
values, and the radix passes start at the first 8-bit digit where they
differ (none for a column of one value); in each pass every slot's lanes
whose entry matches the digits so far add one to the warp's 256-bin
histogram; lane L then scans bins 8L .. 8L + 7 after an
inclusive shuffle scan of the lane totals; the successor pass runs only when
the lower middle value's count falls short of rank n/2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas.medians import pallas_masked_medians_rowcol

from audio_analysis_torch.ops import medians as md

LANES = 32
RADIX = 256
TOP = 0x7FFFFFFF


def lane_slots(col):
    """[slots, 32] bit patterns and validity: row r at [r // 32, r % 32]."""
    n = len(col)
    slots = -(-n // LANES)
    bits = np.zeros(slots * LANES, np.int64)
    bits[:n] = np.asarray(col, np.float32).view(np.int32)
    ok = np.arange(slots * LANES) < n
    return bits.reshape(slots, LANES), ok.reshape(slots, LANES)


def warp_histogram(bits, ok, prefix, mask, shift, stats=None):
    """One pass's atomics: per slot, the lanes whose entry matches the
    digits so far each add one at their next digit. `stats` collects the
    lanes that add, per slot."""
    h = np.zeros(RADIX, np.int64)
    for v, o in zip(bits, ok):
        adds = o & ((v & mask) == prefix)
        np.add.at(h, (v[adds] >> shift) & (RADIX - 1), 1)
        if stats is not None:
            stats.append(int(adds.sum()))
    return h


def scan_pick(h, k):
    """Lane L holds bins 8L .. 8L + 7: its total, an inclusive scan over the
    lanes, then the one bin whose range holds rank k -> (digit, entries
    before its bucket, entries in it)."""
    c = h.reshape(LANES, 8)
    total = c.sum(axis=1)
    run0 = np.cumsum(total) - total
    hits = []
    for lane in range(LANES):
        run = int(run0[lane])
        for i in range(8):
            if run <= k < run + c[lane, i]:
                hits.append((8 * lane + i, run, int(c[lane, i])))
            run += int(c[lane, i])
    assert len(hits) == 1, hits
    return hits[0]


def warp_select_np(bits, ok, k, shift=24, prefix=0, trace=None):
    """warp_radix_select from digit `shift` down -> (value of rank k,
    entries below, entries equal)."""
    mask = -(1 << (shift + 8)) if shift < 24 else 0
    below = equal = 0
    for shift in range(shift, -1, -8):
        h = warp_histogram(bits, ok, prefix, mask, shift)
        digit, before, equal = scan_pick(h, k)
        prefix |= digit << shift
        mask |= (RADIX - 1) << shift
        k -= before
        below += before
        if trace is not None:
            trace["passes"] = trace.get("passes", 0) + 1
    return prefix, below, equal


def column_median_np(col, from_top=False, trace=None):
    """column_median on one column; `trace` (a dict) records the radix
    passes run and whether the successor pass ran. With `from_top`, the
    passes start at the top digit whatever the least and largest values
    share, as a select without the min/max pass would."""
    bits, ok = lane_slots(col)
    n = len(col)
    least, most = int(bits[ok].min()), int(bits[ok].max())
    shift = 24
    while not from_top and shift >= 0 and (least >> shift) == (most >> shift):
        shift -= 8
    lo, below, equal = least, 0, n
    if trace is not None:
        trace["passes"] = 0
    if shift >= 0:
        prefix = least & -(1 << (shift + 8)) if shift < 24 else 0
        lo, below, equal = warp_select_np(bits, ok, (n - 1) // 2, shift, prefix, trace)
    up = lo
    ran = below + equal < n // 2 + 1
    if ran:
        above = bits[ok & (bits > lo)]
        up = int(above.min()) if len(above) else TOP
    if trace is not None:
        trace["successor"] = ran
    f = np.array([lo, up], np.int64).astype(np.int32).view(np.float32)
    return (f[0] + f[1]) * np.float32(0.5)


def _columns(rng, kind, n, cols=3):
    """[n, cols] float32 columns of one kind."""
    if kind == "zeros":  # digital silence: every column all zero
        return np.zeros((n, cols), np.float32)
    if kind == "ties":
        return (rng.randint(0, 3, size=(n, cols)) * 0.25).astype(np.float32)
    if kind == "digits":  # values that share their leading digits
        base = np.float32(0.75).view(np.int32)
        return (base + rng.randint(0, 300, size=(n, cols))).astype(np.int32).view(np.float32)
    if kind == "wide":
        return (np.abs(rng.randn(n, cols)) * 10.0 ** rng.randint(-35, 35, size=(n, cols))).astype(
            np.float32)
    if kind == "mostly_zero":  # a column at the edge of the silent tail
        x = np.abs(rng.randn(n, cols)).astype(np.float32)
        x[rng.rand(n, cols) < 0.9] = 0.0
        return x
    return (np.abs(rng.randn(n, cols)) ** 3 / 40.0).astype(np.float32)  # a_max-scaled


@pytest.mark.parametrize("from_top", [False, True], ids=["min-max-start", "top-digit-start"])
@pytest.mark.parametrize("kind", ["random", "zeros", "ties", "digits", "wide", "mostly_zero"])
@pytest.mark.parametrize("n", [1, 2, 31, 64, 65, 2048, 2049])
def test_column_select_equals_np_median(rng, kind, n, from_top):
    """Bit for bit against np.median and the plain version, for odd and even
    row counts, 1 and 2 rows, and 2049 rows (the detection |STFT|'s bins),
    with the kernel's min/max start and with all four passes from the top
    digit (the skipped digits change nothing)."""
    x = _columns(rng, kind, n)
    want = np.median(x, axis=0).astype(np.float32)
    got = np.array([column_median_np(x[:, c], from_top) for c in range(x.shape[1])],
                   np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = md.col_medians_plain(torch.from_numpy(x)[None])
    np.testing.assert_array_equal(plain[0, 0].numpy().view(np.int32), want.view(np.int32))


def test_lane_ownership():
    """Row r is lane r % 32, slot r // 32; slots past the column's end are
    not valid."""
    col = np.arange(70, dtype=np.float32)
    bits, ok = lane_slots(col)
    assert bits.shape == ok.shape == (3, 32)
    for r in range(96):
        j, lane = divmod(r, 32)
        assert ok[j, lane] == (r < 70)
        if r < 70:
            assert bits[j, lane] == np.float32(r).view(np.int32)


@pytest.mark.parametrize("kind", ["random", "zeros", "ties", "digits", "wide"])
def test_pass_counts_equal_the_digit_histogram(rng, kind):
    """Each pass's histogram, one atomic per matching entry, is the bincount
    of the matching entries' digits, and every slot adds once for each of
    its lanes that matches: 32 a slot on an all-zero column, whose entries
    all share one address."""
    col = _columns(rng, kind, 2049, cols=1)[:, 0]
    bits, ok = lane_slots(col)
    flat = bits[ok]
    prefix = mask = 0
    k = (len(col) - 1) // 2
    for shift in (24, 16, 8, 0):
        stats = []
        h = warp_histogram(bits, ok, prefix, mask, shift, stats=stats)
        sel = (flat & mask) == prefix
        want = np.bincount((flat[sel] >> shift) & 255, minlength=256)
        np.testing.assert_array_equal(h, want)
        for v, o, adds in zip(bits, ok, stats):
            assert adds == int((o & ((v & mask) == prefix)).sum())
        if kind == "zeros":
            assert stats == [int(o.sum()) for o in ok] and stats[0] == 32
        digit, before, _ = scan_pick(h, k)
        prefix |= digit << shift
        mask |= 255 << shift
        k -= before


@pytest.mark.parametrize("kind,passes", [("zeros", 0), ("ties", 4), ("random", 4)])
def test_least_and_largest_skip_the_shared_digits(rng, kind, passes):
    """The radix passes start at the first digit where the column's least
    and largest values differ: none for an all-zero column, all four where
    zeros meet nonzero values; values that share their top 16 bits take two
    passes; and a column of one nonzero value takes none."""
    col = _columns(rng, kind, 2049, cols=1)[:, 0]
    trace = {}
    got = column_median_np(col, trace=trace)
    assert trace["passes"] == passes
    assert got.view(np.int32) == np.float32(np.median(col)).view(np.int32)
    base = np.float32(0.75).view(np.int32)
    near = (base + rng.randint(0, 2 ** 16, size=2049)).astype(np.int32).view(np.float32)
    trace = {}
    assert column_median_np(near, trace=trace) == np.float32(np.median(near))
    assert trace["passes"] == 2
    trace = {}
    assert column_median_np(np.full(2049, 0.375, np.float32), trace=trace) == np.float32(0.375)
    assert trace["passes"] == 0


def test_scan_picks_every_rank(rng):
    """Every rank of a 300-row column with ties and shared digits selects
    the sorted value of that rank, with its counts below and equal."""
    col = (rng.randint(0, 6, size=300) * 0.125 + 0.5).astype(np.float32)
    # the float just above 0.5: it shares the first three digits with 0.5
    col[::7] = np.array([np.float32(0.5).view(np.int32) + 1], np.int32).view(np.float32)[0]
    bits, ok = lane_slots(col)
    order = np.sort(bits[ok])
    for k in range(len(order)):
        value, below, equal = warp_select_np(bits, ok, k)
        assert value == order[k]
        assert below == int((order < value).sum())
        assert equal == int((order == value).sum())


@pytest.mark.parametrize("col,runs", [
    ([0.5, 0.25, 0.75], False),           # odd: rank n/2 is rank (n-1)/2
    ([0.5, 0.25, 0.75, 1.0], True),        # even, distinct middles
    ([0.5, 0.5, 0.25, 0.75], False),       # even, the lower middle repeats
    ([0.0, 0.0], False),                   # even, all equal
    ([0.0, 0.125], True),                  # two rows
])
def test_successor_pass_runs_only_when_needed(col, runs):
    col = np.asarray(col, np.float32)
    trace = {}
    got = column_median_np(col, trace=trace)
    assert trace["successor"] == runs
    assert got.view(np.int32) == np.float32(np.median(col)).view(np.int32)


@pytest.mark.parametrize("kind,bins,t,nvf", [
    ("random", 37, 24, 24), ("ties", 40, 20, 13), ("mostly_zero", 33, 16, 9),
    ("digits", 64, 12, 12),
])
def test_transcription_matches_the_pallas_kernel(rng, kind, bins, t, nvf):
    """The transcription's column medians equal the JAX Pallas kernel's (in
    interpret mode) over the valid columns, and the plain version's
    everywhere."""
    spec = _columns(rng, kind, bins, cols=t)
    got = np.array([column_median_np(spec[:, c]) for c in range(t)], np.float32)
    _, p_col = pallas_masked_medians_rowcol(jnp.asarray(spec)[None], jnp.asarray([nvf]),
                                            interpret=True)
    np.testing.assert_array_equal(got[:nvf], np.asarray(p_col)[0, 0, :nvf])
    plain = md.col_medians(torch.from_numpy(spec)[None])
    np.testing.assert_array_equal(got, plain[0, 0].numpy())
