// Ink-bound expansion of detection quads — native host op.
//
// Role: engine/detector._ink_snap's expand_only path (the serving default,
// det_ink_expand), one call per page from Detector._ink_and_emit. DB's
// stride-2 probability map quantizes box edges, so each axis-aligned quad
// walks its edges outward over connected ink —
// recovering clipped first/last glyphs and the under-sized DB response on
// large bold text — bounded per edge and stopped by rules/neighbor rows.
// The Python walk holds the GIL for every box, against the scheduler's
// det/rec thread overlap; this batch op does a page's quads in one call,
// which ctypes makes without the GIL. native/plain.ink_expand_batch is the
// Python walk over the same quads.
//
// Semantics mirror detector._ink_snap(expand_only=True) exactly:
//   bg     = 90th percentile of the 2x2-subsampled walk window
//   ink_t  = max(bg - 50, (win_min + bg) / 2)
//   dark_cols over the box's own row band only
//   horizontal: walk outward while the adjacent column has ink
//   vertical:   walk over glyph-like rows (ink count in [max(3, 3% span),
//               90% span]) — a near-solid row is a table rule, a 1-2 px
//               row is a vertical rule; both stop the walk
//
// C ABI for ctypes: no C++ types cross the boundary.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// gray: (h, w) uint8 page. quads: (n, 4, 2) float32, axis-aligned,
// modified IN PLACE. max_walk_ratio bounds each edge's walk by
// ratio * box_height.
void ink_expand_batch(const uint8_t* gray, int32_t h, int32_t w,
                      float* quads, int32_t n, float max_walk_ratio) {
  std::vector<int32_t> dark_band;   // per-column ink count, box row band
  std::vector<int32_t> row_cnt;     // per-row ink count, expanded x span
  for (int32_t q = 0; q < n; ++q) {
    float* quad = quads + q * 8;
    float qx0 = quad[0], qx1 = quad[0], qy0 = quad[1], qy1 = quad[1];
    for (int k = 1; k < 4; ++k) {
      qx0 = std::min(qx0, quad[2 * k]);
      qx1 = std::max(qx1, quad[2 * k]);
      qy0 = std::min(qy0, quad[2 * k + 1]);
      qy1 = std::max(qy1, quad[2 * k + 1]);
    }
    int32_t x0 = std::min(std::max(static_cast<int32_t>(qx0), 0), w - 1);
    int32_t x1 = std::min(std::max(static_cast<int32_t>(qx1), x0 + 1), w);
    int32_t y0 = std::min(std::max(static_cast<int32_t>(qy0), 0), h - 1);
    int32_t y1 = std::min(std::max(static_cast<int32_t>(qy1), y0 + 1), h);
    int32_t box_h = y1 - y0;
    int32_t walk = std::max(static_cast<int32_t>(box_h * max_walk_ratio), 2);
    int32_t wy0 = std::max(y0 - walk, 0), wy1 = std::min(y1 + walk, h);
    int32_t wx0 = std::max(x0 - walk, 0), wx1 = std::min(x1 + walk, w);
    if (wy1 <= wy0 || wx1 <= wx0) continue;

    // background percentile over the 2x2-subsampled window; min over the
    // FULL window (matches detector._ink_snap exactly)
    int32_t hist[256] = {0};
    int32_t total = 0;
    uint8_t win_min = 255;
    bool sub = (wy1 - wy0) > 8 && (wx1 - wx0) > 8;
    int32_t step = sub ? 2 : 1;
    for (int32_t y = wy0; y < wy1; ++y) {
      const uint8_t* row = gray + static_cast<int64_t>(y) * w;
      bool hist_row = ((y - wy0) % step) == 0;
      for (int32_t x = wx0; x < wx1; ++x) {
        uint8_t v = row[x];
        win_min = std::min(win_min, v);
        if (hist_row && ((x - wx0) % step) == 0) {
          ++hist[v];
          ++total;
        }
      }
    }
    if (total == 0) continue;
    // NOTE: matches np.searchsorted(cumsum, 0.9 * total) — the first bin
    // whose cumulative count reaches 90% of the window
    double target = 0.9 * total;
    int32_t csum = 0, bg = 255;
    for (int32_t v = 0; v < 256; ++v) {
      csum += hist[v];
      if (csum >= target) { bg = v; break; }
    }
    float ink_t = std::max(static_cast<float>(bg) - 50.0f,
                           (static_cast<float>(win_min) + bg) / 2.0f);

    // per-column ink counts over the box's own row band [y0, y1)
    dark_band.assign(wx1 - wx0, 0);
    for (int32_t y = y0; y < y1; ++y) {
      const uint8_t* row = gray + static_cast<int64_t>(y) * w;
      for (int32_t x = wx0; x < wx1; ++x)
        dark_band[x - wx0] += row[x] < ink_t;
    }

    // horizontal walk over connected ink
    int32_t nx0 = x0;
    while (nx0 - 1 >= wx0 && dark_band[nx0 - 1 - wx0] > 0) --nx0;
    int32_t nx1 = x1;
    while (nx1 < wx1 - 1 && dark_band[std::min(nx1, wx1 - 1) - wx0] > 0)
      ++nx1;
    nx0 = std::min(nx0, x0);
    nx1 = std::max(nx1, x1);

    // per-row ink counts over the expanded x span, full window rows
    int32_t sx0 = nx0, sx1 = std::max(nx1, nx0 + 1);
    int32_t span = sx1 - sx0;
    row_cnt.assign(wy1 - wy0, 0);
    for (int32_t y = wy0; y < wy1; ++y) {
      const uint8_t* row = gray + static_cast<int64_t>(y) * w;
      int32_t c = 0;
      for (int32_t x = sx0; x < sx1 && x < w; ++x) c += row[x] < ink_t;
      row_cnt[y - wy0] = c;
    }
    bool any_ink = false;
    for (int32_t c : row_cnt) any_ink |= c > 0;
    if (!any_ink) continue;

    int32_t lo = std::max(3, static_cast<int32_t>(0.03 * span));
    double hi = 0.9 * span;
    auto row_ink = [&](int32_t idx) {
      int32_t c = row_cnt[idx];
      return c >= lo && c <= hi;
    };
    int32_t ny0 = y0, ny1 = y1;
    int32_t lim0 = std::max(y0 - walk, wy0), lim1 = std::min(y1 + walk, wy1);
    while (ny0 - 1 >= lim0 && row_ink(ny0 - 1 - wy0)) --ny0;
    int32_t last = static_cast<int32_t>(row_cnt.size()) - 1;
    while (ny1 < lim1 && row_ink(std::min(ny1 - wy0, last))) ++ny1;

    quad[0] = static_cast<float>(nx0); quad[1] = static_cast<float>(ny0);
    quad[2] = static_cast<float>(nx1); quad[3] = static_cast<float>(ny0);
    quad[4] = static_cast<float>(nx1); quad[5] = static_cast<float>(ny1);
    quad[6] = static_cast<float>(nx0); quad[7] = static_cast<float>(ny1);
  }
}

}  // extern "C"
