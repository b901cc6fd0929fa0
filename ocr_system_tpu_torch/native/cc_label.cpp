// Connected-components labeling (8-connectivity) — native host op.
//
// Role: every host labelling of the served path: the probability-map box
// path (ops/boxes.py), the classical detector's glyph and word blobs
// (engine/classical_detector.py), script routing (engine/script.py) and the
// page components of the mark and handwriting passes
// (engine/selection_marks.py). Two-pass union-find with path compression;
// the union keeps the smaller provisional id as the root, so components
// are numbered in raster order of their first pixel (scipy.ndimage.label's
// order). Called through ctypes, which releases the GIL for the call.
// native/plain.py holds the numpy/scipy version of each function.
//
// C ABI for ctypes: no C++ types cross the boundary.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;

  explicit UnionFind(size_t cap) { parent.reserve(cap); }

  int32_t make() {
    int32_t id = static_cast<int32_t>(parent.size());
    parent.push_back(id);
    return id;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// img: h*w uint8 (0/1). out: h*w int32 labels, 0 = background, 1..n
// components. Returns n (number of components), or -1 on bad args.
int32_t cc_label_u8(const uint8_t* img, int32_t h, int32_t w, int32_t* out) {
  if (!img || !out || h <= 0 || w <= 0) return -1;
  UnionFind uf(1024);
  uf.make();  // label 0 reserved for background

  // Pass 1: provisional labels, merging with W, NW, N, NE neighbors.
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<int64_t>(y) * w;
    int32_t* lrow = out + static_cast<int64_t>(y) * w;
    const int32_t* lup = y > 0 ? out + static_cast<int64_t>(y - 1) * w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      if (!row[x]) { lrow[x] = 0; continue; }
      int32_t label = 0;
      if (x > 0 && lrow[x - 1]) label = lrow[x - 1];
      if (lup) {
        for (int32_t dx = -1; dx <= 1; ++dx) {
          int32_t nx = x + dx;
          if (nx < 0 || nx >= w) continue;
          int32_t nl = lup[nx];
          if (!nl) continue;
          if (!label) label = nl;
          else uf.unite(label, nl);
        }
      }
      if (!label) label = uf.make();
      lrow[x] = label;
    }
  }

  // Compact roots to 1..n.
  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t n = 0;
  for (size_t i = 1; i < uf.parent.size(); ++i) {
    int32_t root = uf.find(static_cast<int32_t>(i));
    if (remap[root] == 0 && root == static_cast<int32_t>(i)) remap[root] = ++n;
  }
  // Roots may not be minimal ids in all orders; ensure every provisional id
  // maps through its root.
  for (size_t i = 1; i < uf.parent.size(); ++i) {
    int32_t root = uf.find(static_cast<int32_t>(i));
    if (remap[root] == 0) remap[root] = ++n;
    remap[i] = remap[root];
  }

  // Pass 2: resolve.
  int64_t total = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < total; ++i) {
    if (out[i]) out[i] = remap[out[i]];
  }
  return n;
}

// OpenCV's label order (cv2.connectedComponentsWithStats, 8-connected):
// its scan visits 2 x 2 blocks, row pairs top to bottom and blocks left to
// right, and numbers a component at the first block that holds one of its
// pixels. The foreground pixels of one block are 8-adjacent, so no two
// components share a block. Renumbers raster-order labels (1..n) to that
// order in place. Returns n, or -1 on bad args.
int32_t cc_block_order(int32_t* labels, int32_t h, int32_t w, int32_t n) {
  if (!labels || h <= 0 || w <= 0 || n < 0) return -1;
  std::vector<int32_t> remap(static_cast<size_t>(n) + 1, 0);
  int32_t next = 0;
  for (int32_t by = 0; by < h && next < n; by += 2) {
    const int32_t* r0 = labels + static_cast<int64_t>(by) * w;
    const int32_t* r1 = by + 1 < h ? r0 + w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      // the block's pixels share one label, so any of them names it
      int32_t l = r0[x];
      if (!l && r1) l = r1[x];
      if (l && !remap[l]) remap[l] = ++next;
    }
  }
  int64_t total = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < total; ++i) labels[i] = remap[labels[i]];
  return n;
}

// Fused component statistics: per-label pixel count, probability sum, and
// bounding box — lets Python skip three bincount/nonzero passes.
// labels: h*w int32 (from cc_label_u8), prob: h*w float32.
// counts/sums: size n+1; bboxes: (n+1)*4 int32 as x0,y0,x1,y1.
void cc_stats(const int32_t* labels, const float* prob, int32_t h, int32_t w,
              int32_t n, int64_t* counts, double* sums, int32_t* bboxes) {
  for (int32_t i = 0; i <= n; ++i) {
    counts[i] = 0;
    sums[i] = 0.0;
    bboxes[i * 4 + 0] = w; bboxes[i * 4 + 1] = h;
    bboxes[i * 4 + 2] = -1; bboxes[i * 4 + 3] = -1;
  }
  for (int32_t y = 0; y < h; ++y) {
    const int32_t* lrow = labels + static_cast<int64_t>(y) * w;
    const float* prow = prob + static_cast<int64_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      int32_t l = lrow[x];
      if (!l || l > n) continue;
      counts[l]++;
      sums[l] += prow[x];
      int32_t* bb = bboxes + static_cast<int64_t>(l) * 4;
      if (x < bb[0]) bb[0] = x;
      if (y < bb[1]) bb[1] = y;
      if (x > bb[2]) bb[2] = x;
      if (y > bb[3]) bb[3] = y;
    }
  }
}

// Fully fused label + per-component analysis: one labeling pass, then one
// resolve pass that simultaneously accumulates everything the detection box
// extractor needs — pixel count, probability sum, bounding box, and raw
// second moments (for the principal-axis angle gate). Replaces ~15 separate
// full-map numpy passes (nonzero, argsort, 6x bincount, reduceat) that each
// held the GIL between kernels on the 1-core serving host.
//
// img: h*w uint8 (0/1). prob: ph*pw float32, sampled at (y/stride, x/stride)
// — pass stride=1 (ph=h, pw=w) for a full-resolution probability map, or the
// pooled score map + its stride for the 1-bit wire format.
// cap: max components the caller allocated for. labels: h*w int32 out.
// counts/score_sums: cap+1. bboxes: (cap+1)*4 int32 x0,y0,x1,y1.
// moments: (cap+1)*5 double sum_x, sum_y, sum_xx, sum_yy, sum_xy.
// Returns n components, -1 on bad args, -2 if n > cap (caller re-calls with
// a larger cap; labels/stat buffers are undefined in that case).
int32_t cc_analyze_u8(const uint8_t* img, int32_t h, int32_t w,
                      const float* prob, int32_t ph, int32_t pw,
                      int32_t stride, int32_t cap, int32_t* labels,
                      int64_t* counts, double* score_sums, int32_t* bboxes,
                      double* moments) {
  if (!img || !prob || !labels || !counts || !score_sums || !bboxes ||
      !moments || h <= 0 || w <= 0 || ph <= 0 || pw <= 0 || stride <= 0 ||
      cap < 0)
    return -1;
  UnionFind uf(1024);
  uf.make();  // label 0 reserved for background

  // Pass 1: provisional labels, merging with W, NW, N, NE neighbors.
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<int64_t>(y) * w;
    int32_t* lrow = labels + static_cast<int64_t>(y) * w;
    const int32_t* lup =
        y > 0 ? labels + static_cast<int64_t>(y - 1) * w : nullptr;
    for (int32_t x = 0; x < w; ++x) {
      if (!row[x]) { lrow[x] = 0; continue; }
      int32_t label = 0;
      if (x > 0 && lrow[x - 1]) label = lrow[x - 1];
      if (lup) {
        for (int32_t dx = -1; dx <= 1; ++dx) {
          int32_t nx = x + dx;
          if (nx < 0 || nx >= w) continue;
          int32_t nl = lup[nx];
          if (!nl) continue;
          if (!label) label = nl;
          else uf.unite(label, nl);
        }
      }
      if (!label) label = uf.make();
      lrow[x] = label;
    }
  }

  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t n = 0;
  for (size_t i = 1; i < uf.parent.size(); ++i) {
    int32_t root = uf.find(static_cast<int32_t>(i));
    if (remap[root] == 0) remap[root] = ++n;
    remap[i] = remap[root];
  }
  if (n > cap) return -2;

  for (int32_t i = 0; i <= n; ++i) {
    counts[i] = 0;
    score_sums[i] = 0.0;
    bboxes[i * 4 + 0] = w; bboxes[i * 4 + 1] = h;
    bboxes[i * 4 + 2] = -1; bboxes[i * 4 + 3] = -1;
    for (int32_t k = 0; k < 5; ++k) moments[i * 5 + k] = 0.0;
  }

  // Pass 2: resolve labels and accumulate all per-component statistics.
  for (int32_t y = 0; y < h; ++y) {
    int32_t* lrow = labels + static_cast<int64_t>(y) * w;
    int32_t py = y / stride;
    if (py >= ph) py = ph - 1;
    const float* prow = prob + static_cast<int64_t>(py) * pw;
    const double dy = static_cast<double>(y);
    for (int32_t x = 0; x < w; ++x) {
      int32_t l = lrow[x];
      if (!l) continue;
      l = remap[l];
      lrow[x] = l;
      counts[l]++;
      int32_t px = x / stride;
      if (px >= pw) px = pw - 1;
      score_sums[l] += prow[px];
      int32_t* bb = bboxes + static_cast<int64_t>(l) * 4;
      if (x < bb[0]) bb[0] = x;
      if (y < bb[1]) bb[1] = y;
      if (x > bb[2]) bb[2] = x;
      if (y > bb[3]) bb[3] = y;
      double* m = moments + static_cast<int64_t>(l) * 5;
      const double dx = static_cast<double>(x);
      m[0] += dx;
      m[1] += dy;
      m[2] += dx * dx;
      m[3] += dy * dy;
      m[4] += dx * dy;
    }
  }
  return n;
}

}  // extern "C"
