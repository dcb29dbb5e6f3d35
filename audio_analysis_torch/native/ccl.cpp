// Connected-component labelling with stats (8-connectivity), run-based
// union-find. Native host op replacing OpenCV's
// connectedComponentsWithStats in the signal-detection path
// (reference: src/identify_tracks.py:686-691).
//
// Exposed via a C ABI for ctypes:
//   int64 ccl_stats_words(const uint32* words, int64 h, int64 w,
//                         int64 words_per_row, int64* out /*[n,5]*/)
// over the device's bit-packed mask: each row `words_per_row` words, bit 31
// of word j the column 32 j (most significant bit first), `w` the logical
// width. Returns the number of components; out rows are (x, y, w, h, area),
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

// Union runs across rows, aggregate stats.
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

// Reads the packed mask as it comes from the device, with no host unpack of
// the ~21 MB mask per recording. Runs are clamped to the logical width and
// runs wholly in pad bits dropped, so a producer that leaves its pad bits set
// gets no spurious zero-area components (finish_ccl has no such filter).
extern "C" int64_t ccl_stats_words(const uint32_t* words, int64_t h, int64_t w,
                                   int64_t words_per_row, int64_t* out) {
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int64_t> row_first(h + 1, -1);  // index of first run per row

  for (int64_t y = 0; y < h; ++y) {
    const uint32_t* row = words + y * words_per_row;
    int64_t run_start = -1;
    auto close = [&](int64_t end) {  // the open run ends before `end`
      end = std::min(end, w);
      if (run_start < end) {
        if (row_first[y] < 0) row_first[y] = static_cast<int64_t>(runs.size());
        runs.push_back({y, run_start, end});
      }
      run_start = -1;
    };
    for (int64_t j = 0; j < words_per_row; ++j) {
      const uint32_t word = row[j];
      const int64_t x = 32 * j;
      if (word == 0) {
        if (run_start >= 0) close(x);
        continue;
      }
      if (word == 0xFFFFFFFFu) {
        if (run_start < 0) run_start = x;
        continue;
      }
      for (int bit = 31; bit >= 0; --bit) {
        const bool on = (word >> bit) & 1u;
        if (on && run_start < 0) {
          run_start = x + 31 - bit;
        } else if (!on && run_start >= 0) {
          close(x + 31 - bit);
        }
      }
    }
    if (run_start >= 0) close(32 * words_per_row);
  }
  row_first[h] = static_cast<int64_t>(runs.size());
  return finish_ccl(runs, row_first, h, out);
}
