"""Connected components with stats (host op).

TPU-native replacement for ``cv2.connectedComponentsWithStats``
(reference: src/identify_tracks.py:686-691). Labelling is an inherently
sequential union-find, so it runs on host over the (small, binary) mask that
the on-device morphology produces. Two implementations:

- a native C++ run-based union-find (audio_analysis_torch/native/ccl.cpp),
  loaded via ctypes — the production path;
- a vectorised numpy run-based union-find fallback with identical output.

Both use 8-connectivity (cv2's default) and return per-component
``(x, y, w, h, area)`` stats excluding the background, matching cv2's stats
columns (CC_STAT_LEFT/TOP/WIDTH/HEIGHT/AREA).
"""

import numpy as np

from audio_analysis_torch.native import load_ccl_library


def _runs_of_rows(mask: np.ndarray):
    """Extract horizontal runs: returns (row, start_col, end_col_exclusive)."""
    m = mask.astype(bool)
    h, w = m.shape
    padded = np.zeros((h, w + 2), dtype=np.int8)
    padded[:, 1:-1] = m
    d = np.diff(padded, axis=1)
    rows, starts = np.nonzero(d == 1)
    rows2, ends = np.nonzero(d == -1)
    # diff semantics give equal counts and aligned order per row
    return rows, starts, ends


class _UnionFind:
    __slots__ = ("parent",)

    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i):
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _connected_components_numpy(mask: np.ndarray) -> np.ndarray:
    rows, starts, ends = _runs_of_rows(mask)
    return _ccl_from_runs(rows, starts, ends)


def _ccl_from_runs(rows, starts, ends) -> np.ndarray:
    """Union-find over row-major-ordered horizontal runs (end exclusive)."""
    n_runs = len(rows)
    if n_runs == 0:
        return np.zeros((0, 5), dtype=np.int64)

    uf = _UnionFind(n_runs)
    # runs are emitted in row-major order; merge each run with 8-connected
    # runs of the previous row via a two-pointer sweep.
    row_break = np.nonzero(np.diff(rows))[0] + 1
    row_slices = {}
    prev = 0
    for b in list(row_break) + [n_runs]:
        row_slices[rows[prev]] = (prev, b)
        prev = b
    for r in row_slices:
        if r - 1 not in row_slices:
            continue
        cs, ce = row_slices[r]
        ps, pe = row_slices[r - 1]
        # 8-connectivity with exclusive run ends [s, e): runs touch iff
        # prev.start <= cur.end AND prev.end >= cur.start.
        j = ps
        for i in range(cs, ce):
            s, e = starts[i], ends[i]
            while j < pe and ends[j] < s:
                j += 1
            k = j
            while k < pe and starts[k] <= e:
                uf.union(i, k)
                k += 1

    labels = np.array([uf.find(i) for i in range(n_runs)])
    uniq, inv = np.unique(labels, return_inverse=True)
    n_comp = len(uniq)
    stats = np.zeros((n_comp, 5), dtype=np.int64)
    x0 = np.full(n_comp, np.iinfo(np.int64).max)
    x1 = np.zeros(n_comp, dtype=np.int64)
    y0 = np.full(n_comp, np.iinfo(np.int64).max)
    y1 = np.zeros(n_comp, dtype=np.int64)
    area = np.zeros(n_comp, dtype=np.int64)
    np.minimum.at(x0, inv, starts)
    np.maximum.at(x1, inv, ends)
    np.minimum.at(y0, inv, rows)
    np.maximum.at(y1, inv, rows + 1)
    np.add.at(area, inv, ends - starts)
    stats[:, 0] = x0
    stats[:, 1] = y0
    stats[:, 2] = x1 - x0
    stats[:, 3] = y1 - y0
    stats[:, 4] = area
    return stats


def connected_components_with_stats(mask: np.ndarray) -> np.ndarray:
    """8-connected component stats ``[n, 5] = (x, y, w, h, area)``,
    background excluded. Uses the native C++ op when available."""
    mask = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    lib = load_ccl_library()
    if lib is not None:
        h, w = mask.shape
        max_comp = h * w // 2 + 1
        out = np.zeros((max_comp, 5), dtype=np.int64)
        n = lib.ccl_stats(mask, h, w, out)
        return out[:n]
    return _connected_components_numpy(mask)


def connected_components_with_stats_packed(packed: np.ndarray, width: int) -> np.ndarray:
    """Same, over a bit-packed mask: consumes the device's packed detection
    mask directly, skipping a ~200 ms host unpack per 60 s recording.

    Accepts uint8 bytes (np.packbits layout) or int32 words (MSB-first; the
    device packs int32 because those transfer ~2x faster on this backend) —
    int32 words big-endian-viewed ARE the MSB-first byte stream."""
    packed = np.asarray(packed)
    if packed.dtype != np.uint8:
        packed = np.ascontiguousarray(packed).astype(">i4")
        packed = np.ascontiguousarray(packed).view(np.uint8).reshape(packed.shape[0], -1)
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    h, w_bytes = packed.shape
    lib = load_ccl_library()
    if lib is not None:
        max_comp = h * width // 2 + 2
        out = np.zeros((max_comp, 5), dtype=np.int64)
        n = lib.ccl_stats_packed(packed, h, int(width), w_bytes, out)
        return out[:n]
    mask = np.unpackbits(packed, axis=1)[:, :width] > 0
    return _connected_components_numpy(mask)


def connected_components_with_stats_runs(
    starts: np.ndarray, ends: np.ndarray, n_runs: int, h: int, w: int
) -> np.ndarray:
    """Same stats, from device-extracted horizontal runs: `starts`/`ends`
    are flat row-major pixel indices of each run's first/LAST on-pixel,
    ascending (the device nonzero order; see detect.signal_noise._runs_from_packed_program).
    Only ~n_runs*8 bytes cross the wire instead of the packed mask."""
    n_runs = int(n_runs)
    starts = np.ascontiguousarray(starts[:n_runs], dtype=np.int32)
    ends = np.ascontiguousarray(ends[:n_runs], dtype=np.int32)
    lib = load_ccl_library()
    if lib is not None and getattr(lib, "_fn_runs", None) is not None:
        out = np.zeros((n_runs + 1, 5), dtype=np.int64)
        n = lib.ccl_stats_runs(starts, ends, n_runs, int(h), int(w), out)
        return out[:n]
    rows = starts.astype(np.int64) // w
    return _ccl_from_runs(
        rows,
        starts.astype(np.int64) - rows * w,
        ends.astype(np.int64) - rows * w + 1,
    )
