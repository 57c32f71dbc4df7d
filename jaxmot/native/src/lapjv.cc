// Exact min-cost assignment (Hungarian algorithm with potentials, O(n^3))
// — the native host-side solver of the data-association layer.
//
// Role: the reference solves track<->detection assignment with a native
// Hungarian solver (SURVEY.md section 2, row "hungarian").  The
// framework's hot path runs the on-device auction (ops/assignment.py);
// this solver is the exact host-side companion for offline scoring,
// oracle cross-checks, and CPU-only deployments, callable via ctypes
// (jaxmot/native/__init__.py).
//
// Implementation: the classic potentials formulation — for each row run a
// Dijkstra-style alternating-path search over columns, maintaining dual
// potentials u/v so reduced costs stay non-negative; augment along the
// found path.  Rectangular inputs are handled by padding internally.

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: n x m row-major; infeasible entries hold `big` (>= any real cost).
// row_to_col out: length n, -1 when the row ends unmatched (only matches
// with cost < big/2 are reported).
void jaxmot_assign(const double* cost, int32_t n, int32_t m, double big,
                   int32_t* row_to_col) {
  const int32_t dim = n > m ? n : m;
  // Padded square matrix: missing entries cost `big` as well.
  auto at = [&](int32_t i, int32_t j) -> double {
    return (i < n && j < m) ? cost[static_cast<int64_t>(i) * m + j] : big;
  };

  const double kInf = std::numeric_limits<double>::infinity();
  std::vector<double> u(dim + 1, 0.0), v(dim + 1, 0.0);
  std::vector<int32_t> match(dim + 1, 0);   // column -> row (1-based rows)
  std::vector<int32_t> way(dim + 1, 0);

  for (int32_t i = 1; i <= dim; ++i) {
    match[0] = i;
    int32_t j0 = 0;
    std::vector<double> minv(dim + 1, kInf);
    std::vector<char> used(dim + 1, 0);
    do {
      used[j0] = 1;
      const int32_t i0 = match[j0];
      double delta = kInf;
      int32_t j1 = 0;
      for (int32_t j = 1; j <= dim; ++j) {
        if (used[j]) continue;
        const double cur = at(i0 - 1, j - 1) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int32_t j = 0; j <= dim; ++j) {
        if (used[j]) {
          u[match[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (match[j0] != 0);
    do {
      const int32_t j1 = way[j0];
      match[j0] = match[j1];
      j0 = j1;
    } while (j0 != 0);
  }

  for (int32_t i = 0; i < n; ++i) row_to_col[i] = -1;
  for (int32_t j = 1; j <= dim; ++j) {
    const int32_t i = match[j] - 1;
    if (i >= 0 && i < n && j - 1 < m && at(i, j - 1) < big * 0.5) {
      row_to_col[i] = j - 1;
    }
  }
}

}  // extern "C"
