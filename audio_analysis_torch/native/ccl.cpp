// Connected-component labelling with stats (8-connectivity), run-based
// union-find. Native host op replacing OpenCV's
// connectedComponentsWithStats in the signal-detection path
// (reference: src/identify_tracks.py:686-691).
//
// Exposed via a C ABI for ctypes:
//   int64 ccl_stats(const uint8* mask, int64 h, int64 w, int64* out /*[n,5]*/)
// Returns the number of components; out rows are (x, y, w, h, area),
// background excluded, in ascending root order (caller sorts as needed).

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {

struct Run {
  int64_t row;
  int64_t start;  // inclusive
  int64_t end;    // exclusive
};

struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int64_t>(i);
  }
  int64_t find(int64_t i) {
    int64_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {
      int64_t next = parent[i];
      parent[i] = root;
      i = next;
    }
    return root;
  }
  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
  }
};

}  // namespace

namespace {

// Shared second phase: union runs across rows, aggregate stats.
int64_t finish_ccl(std::vector<Run>& runs, std::vector<int64_t>& row_first,
                   int64_t h, int64_t* out);

}  // namespace

extern "C" int64_t ccl_stats(const uint8_t* mask, int64_t h, int64_t w,
                             int64_t* out) {
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int64_t> row_first(h + 1, -1);  // index of first run per row

  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = mask + y * w;
    int64_t x = 0;
    while (x < w) {
      while (x < w && !row[x]) ++x;
      if (x >= w) break;
      int64_t s = x;
      while (x < w && row[x]) ++x;
      if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
      runs.push_back({y, s, x});
    }
    row_first[y + 1] = static_cast<int64_t>(runs.size());
  }
  return finish_ccl(runs, row_first, h, out);
}

// Bit-packed variant: mask rows are packed 8 pixels/byte, MSB first
// (np.packbits layout); `w` is the logical pixel width, `w_bytes` the row
// stride. Avoids a host-side unpack of the ~21 MB mask per recording.
extern "C" int64_t ccl_stats_packed(const uint8_t* packed, int64_t h,
                                    int64_t w, int64_t w_bytes, int64_t* out) {
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int64_t> row_first(h + 1, -1);

  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = packed + y * w_bytes;
    int64_t run_start = -1;
    int64_t x = 0;
    for (int64_t b = 0; b < w_bytes; ++b) {
      uint8_t byte = row[b];
      if (byte == 0) {
        if (run_start >= 0) {
          if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
          runs.push_back({y, run_start, x});
          run_start = -1;
        }
        x += 8;
        continue;
      }
      if (byte == 0xFF) {
        if (run_start < 0) run_start = x;
        x += 8;
        continue;
      }
      for (int bit = 7; bit >= 0; --bit, ++x) {
        bool on = (byte >> bit) & 1;
        if (on && run_start < 0) {
          run_start = x;
        } else if (!on && run_start >= 0) {
          if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
          runs.push_back({y, run_start, x});
          run_start = -1;
        }
      }
    }
    if (run_start >= 0) {
      int64_t end = std::min(x, w);
      if (run_start < w) {
        if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
        runs.push_back({y, run_start, end});
      }
      run_start = -1;
    } else if (!runs.empty() && runs.back().row == y && runs.back().end > w) {
      runs.back().end = w;  // clamp trailing pad bits
    }
    // clamp any run that spilled into pad bits
    row_first[y + 1] = static_cast<int64_t>(runs.size());
  }
  // Clamp run ends to the logical width and DROP runs living entirely in
  // pad bits (end <= start after the clamp): finish_ccl has no degenerate
  // filter, so without this a non-zero-padding producer would get spurious
  // zero-area components. row_first is rebuilt over the compacted list.
  std::vector<Run> kept;
  kept.reserve(runs.size());
  std::fill(row_first.begin(), row_first.end(), static_cast<int64_t>(-1));
  for (auto& r : runs) {
    if (r.end > w) r.end = w;
    if (r.start >= r.end) continue;
    if (row_first[r.row] < 0) row_first[r.row] = static_cast<int64_t>(kept.size());
    kept.push_back(r);
  }
  row_first[h] = static_cast<int64_t>(kept.size());
  return finish_ccl(kept, row_first, h, out);
}

// Run-list variant: the device already extracted horizontal runs (see
// detect/signal_noise._runs_from_packed_program) so only ~KBs cross the wire instead of
// the ~2.6 MB packed mask. starts/ends are flat row-major indices
// (row*w + col, end exclusive within the row), sorted ascending (the
// device nonzero order), n_runs of them; entries beyond n_runs ignored.
extern "C" int64_t ccl_stats_runs(const int32_t* starts, const int32_t* ends,
                                  int64_t n_runs, int64_t h, int64_t w,
                                  int64_t* out) {
  std::vector<Run> runs;
  runs.reserve(static_cast<size_t>(n_runs));
  std::vector<int64_t> row_first(h + 1, -1);
  for (int64_t i = 0; i < n_runs; ++i) {
    const int64_t s = starts[i];
    const int64_t e = ends[i];  // flat index of the run's LAST pixel
    const int64_t y = s / w;
    const int64_t x0 = s - y * w;
    const int64_t x1 = e - y * w + 1;  // exclusive
    if (y < 0 || y >= h || x1 <= x0 || x1 > w) continue;
    if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
    runs.push_back({y, x0, x1});
  }
  row_first[h] = static_cast<int64_t>(runs.size());
  return finish_ccl(runs, row_first, h, out);
}

namespace {

int64_t finish_ccl(std::vector<Run>& runs, std::vector<int64_t>& row_first,
                   int64_t h, int64_t* out) {
  // normalise row_first: rows with no runs point at the next row's start
  for (int64_t y = h - 1; y >= 0; --y)
    if (row_first[y] < 0) row_first[y] = row_first[y + 1];

  const int64_t n_runs = static_cast<int64_t>(runs.size());
  if (n_runs == 0) return 0;

  UnionFind uf(static_cast<size_t>(n_runs));
  for (int64_t y = 1; y < h; ++y) {
    int64_t ci = row_first[y];
    const int64_t cend = row_first[y + 1];
    int64_t pi = row_first[y - 1];
    const int64_t pend = row_first[y];
    // two-pointer sweep; 8-connectivity: runs touch if
    // prev.end >= cur.start - 1 && prev.start <= cur.end (end exclusive).
    while (ci < cend && pi < pend) {
      const Run& c = runs[ci];
      const Run& p = runs[pi];
      if (p.end + 1 <= c.start) { ++pi; continue; }
      if (c.end + 1 <= p.start) { ++ci; continue; }
      uf.unite(ci, pi);
      // advance whichever run ends first (keep the other for more overlaps)
      if (p.end < c.end) ++pi; else ++ci;
    }
  }

  // aggregate stats per root
  std::vector<int64_t> root_to_comp(n_runs, -1);
  int64_t n_comp = 0;
  for (int64_t i = 0; i < n_runs; ++i) {
    int64_t r = uf.find(i);
    int64_t comp = root_to_comp[r];
    if (comp < 0) {
      comp = n_comp++;
      root_to_comp[r] = comp;
      int64_t* s = out + comp * 5;
      s[0] = runs[i].start;
      s[1] = runs[i].row;
      s[2] = runs[i].end;   // temporarily x-max (exclusive)
      s[3] = runs[i].row;   // temporarily y-max (inclusive)
      s[4] = 0;
    }
    int64_t* s = out + comp * 5;
    s[0] = std::min(s[0], runs[i].start);
    s[1] = std::min(s[1], runs[i].row);
    s[2] = std::max(s[2], runs[i].end);
    s[3] = std::max(s[3], runs[i].row);
    s[4] += runs[i].end - runs[i].start;
  }
  for (int64_t c = 0; c < n_comp; ++c) {
    int64_t* s = out + c * 5;
    s[2] = s[2] - s[0];      // width
    s[3] = s[3] - s[1] + 1;  // height
  }
  return n_comp;
}

}  // namespace
