// Native path-mask rasterizer.
//
// The reference rasterizes per-path bbox masks with nested Python loops
// over grid cells (src/verilog_parser_asap7.py:1301-1369) — the hottest
// host-side loop of the preprocessing pipeline on large designs. This
// C++ implementation walks each path's consecutive pin-bin pairs,
// stamps the bounding-box cells into a per-path bitmap, and emits
// deduplicated COO indices.
//
// ABI (C, for ctypes):
//   rasterize_paths(
//     arc_x1, arc_y1, arc_x2, arc_y2: int32[num_arcs]  (bin coords)
//     arc_path: int32[num_arcs]    (owning path id, non-decreasing)
//     num_arcs, num_paths, map_size: int32
//     out_rows, out_cols: int64[cap]  (caller-allocated)
//     cap: int64
//   ) -> int64   number of COO entries written, or -1 if cap exceeded.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

int64_t rasterize_paths(const int32_t* arc_x1, const int32_t* arc_y1,
                        const int32_t* arc_x2, const int32_t* arc_y2,
                        const int32_t* arc_path, int64_t num_arcs,
                        int32_t num_paths, int32_t map_size,
                        int64_t* out_rows, int64_t* out_cols,
                        int64_t cap) {
  const int64_t cells = static_cast<int64_t>(map_size) * map_size;
  std::vector<uint8_t> bitmap(cells);
  std::vector<int32_t> touched;
  touched.reserve(1024);
  int64_t n_out = 0;
  int64_t i = 0;
  for (int32_t p = 0; p < num_paths; ++p) {
    // arcs are grouped by path (non-decreasing arc_path)
    touched.clear();
    for (; i < num_arcs && arc_path[i] == p; ++i) {
      int32_t x1 = arc_x1[i], x2 = arc_x2[i];
      int32_t y1 = arc_y1[i], y2 = arc_y2[i];
      if (x1 > x2) { int32_t t = x1; x1 = x2; x2 = t; }
      if (y1 > y2) { int32_t t = y1; y1 = y2; y2 = t; }
      for (int32_t x = x1; x <= x2; ++x) {
        const int64_t base = static_cast<int64_t>(x) * map_size;
        for (int32_t y = y1; y <= y2; ++y) {
          const int64_t c = base + y;
          if (!bitmap[c]) {
            bitmap[c] = 1;
            touched.push_back(static_cast<int32_t>(c));
          }
        }
      }
    }
    if (n_out + static_cast<int64_t>(touched.size()) > cap) return -1;
    // sorted ascending cell order to match the reference's sorted(set())
    // determinism — touched is insertion-ordered; sort it.
    std::sort(touched.begin(), touched.end());
    for (int32_t c : touched) {
      out_rows[n_out] = p;
      out_cols[n_out] = c;
      ++n_out;
      bitmap[c] = 0;  // reset for next path
    }
  }
  return n_out;
}

}  // extern "C"
