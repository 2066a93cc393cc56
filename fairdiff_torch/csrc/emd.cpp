// Exact EMD for the fairness OT targets: a host library (C++17), the
// port's copy of the JAX package's native solver (fairdiff/native/emd.cpp).
//
// Every problem has unit source masses (a = ones(N)) and integer target
// masses b with sum(b) == N, so an integral optimal plan exists and the LP
// is a square assignment on the column-expanded cost (class j repeated b[j]
// times, class-major). It is solved by the shortest augmenting path with
// potentials, O(N^3). Where costs tie, several plans are optimal; this copy
// picks the one the JAX package's solver picks, because it keeps its row
// order, its column scan order, its strict comparisons, the order of its
// potential updates and its double arithmetic. Build it without FMA
// contraction (-ffp-contract=off, kernels/build.py CXX_FLAGS).
//
// C ABI (ctypes, fairness/emd.py):
//   int emd_assignment(const double* cost /* N*C */, const int64_t* b /* C */,
//                      int n, int c, double* plan /* N*C out */);
//   int emd_batch(const double* cost, const int64_t* bs /* D*C */,
//                 int d, int n, int c, double* plans /* D*N*C out */);
// Return 0 on success, 1 on a mass mismatch (or a negative mass), 2 when no
// augmenting column is found (non-finite costs).

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Square assignment on the implicit cost(i, j) = cost_nc[i * c + col_of[j]].
// Returns 0, or -1 when no augmenting column is found (only with non-finite
// costs, which the Python side rejects first); it then writes nothing
// through j1 == -1.
int solve_assignment(const double* cost_nc, const int* col_of, int n, int c,
                     int* row_to_col) {
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, n);  // p[j]: the row matched to column j (n: none)
  std::vector<int> way(n + 1, 0);
  for (int i = 0; i < n; ++i) {
    // augment from row i
    std::vector<double> minv(n + 1, kInf);
    std::vector<char> used(n + 1, 0);
    int j0 = n;  // the virtual start column
    p[n] = i;
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = kInf;
      for (int j = 0; j < n; ++j) {
        if (used[j]) continue;
        double cur = cost_nc[i0 * c + col_of[j]] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return -1;
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != n);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0 != n);
  }
  for (int j = 0; j < n; ++j) row_to_col[p[j]] = j;
  return 0;
}

}  // namespace

extern "C" {

int emd_assignment(const double* cost, const int64_t* b, int n, int c,
                   double* plan) {
  int64_t total = 0;
  for (int j = 0; j < c; ++j) {
    if (b[j] < 0) return 1;
    total += b[j];
  }
  if (total != n) return 1;

  std::vector<int> col_of;
  col_of.reserve(n);
  for (int j = 0; j < c; ++j)
    for (int64_t k = 0; k < b[j]; ++k) col_of.push_back(j);

  std::vector<int> row_to_col(n);
  if (solve_assignment(cost, col_of.data(), n, c, row_to_col.data()) != 0)
    return 2;

  std::memset(plan, 0, sizeof(double) * n * c);
  for (int i = 0; i < n; ++i) plan[i * c + col_of[row_to_col[i]]] = 1.0;
  return 0;
}

int emd_batch(const double* cost, const int64_t* bs, int d, int n, int c,
              double* plans) {
  for (int k = 0; k < d; ++k) {
    int rc = emd_assignment(cost, bs + (size_t)k * c, n, c,
                            plans + (size_t)k * n * c);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
