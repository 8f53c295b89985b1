// Dynamic-programming core for the strategy search.
//
// Native re-implementation of the reference's pybind11 extension
// (reference: csrc/dp_core.cpp:24-124) with a plain extern "C" interface so
// Python loads it via ctypes (pybind11 is not available in this image).
//
// Contract (mirrors the reference): knapsack-style DP over
// (layer, memory, strategy) with inter-layer transition costs.
//   f[v][s]    = min cost to place layers 0..i with s at layer i, mem <= v
//   candidates = f[v - v_data[i][s]][si] + inter_cost[i][si][s] + intra_cost[i][s]
//   mark[i][v][s] = argmin_si   (for backtracking)
// After the sweep, for each candidate vocab-tp the caller supplies
// other_mem[vtp]; we read the best terminal state at v = max_mem-1-other_mem,
// backtrack the per-layer strategy indices, and report
// total_cost[vtp] (+ other_time[vtp]) and remaining memory.
//
// Arrays are C-contiguous, caller-allocated:
//   v_data      int32  [layer_num][strategy_num]
//   mark        int32  [layer_num][max_mem][strategy_num]
//   f           double [max_mem][strategy_num]      (zero-initialised)
//   inter_cost  double [layer_num][strategy_num][strategy_num]
//   intra_cost  double [layer_num][strategy_num]
//   per vtp:    res    int32  [layer_num]
// Build: make -C galvatron_tpu/csrc   (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Runs the full DP sweep. Returns 0 on success.
// Layer i reads layer i-1's table from a separate buffer (not in-place), so
// v_data entries of 0 (sub-MB layers truncated by the caller) cannot alias
// the row being written.
int dp_sweep(int layer_num, int max_mem, int strategy_num,
             const int32_t* v_data, int32_t* mark, double* f,
             const double* inter_cost, const double* intra_cost) {
  const double INF = std::numeric_limits<double>::infinity();
  const int64_t cells = static_cast<int64_t>(max_mem) * strategy_num;
  std::vector<double> prev(f, f + cells);  // layer-(i-1) table
  for (int i = 0; i < layer_num; ++i) {
    for (int v = max_mem - 1; v >= 0; --v) {
      for (int s = 0; s < strategy_num; ++s) {
        const int need = v_data[i * strategy_num + s];
        if (v < need) {
          mark[(static_cast<int64_t>(i) * max_mem + v) * strategy_num + s] = -1;
          f[static_cast<int64_t>(v) * strategy_num + s] = INF;
          continue;
        }
        const double* f_prev = prev.data() + static_cast<int64_t>(v - need) * strategy_num;
        const double* inter = inter_cost + (static_cast<int64_t>(i) * strategy_num) * strategy_num + s;
        double best = INF;
        int best_si = 0;
        for (int si = 0; si < strategy_num; ++si) {
          const double c = f_prev[si] + inter[static_cast<int64_t>(si) * strategy_num];
          if (c < best) {
            best = c;
            best_si = si;
          }
        }
        mark[(static_cast<int64_t>(i) * max_mem + v) * strategy_num + s] = best_si;
        f[static_cast<int64_t>(v) * strategy_num + s] = best + intra_cost[i * strategy_num + s];
      }
    }
    std::copy(f, f + cells, prev.begin());
  }
  return 0;
}

// Backtracks the winning strategy per layer for one memory budget.
// Returns total cost (inf if infeasible); fills res[layer_num] and
// *remaining_mem (-1 if infeasible).
double dp_backtrack(int layer_num, int max_mem, int strategy_num,
                    const int32_t* v_data, const int32_t* mark, const double* f,
                    int other_mem, int32_t* res, int* remaining_mem) {
  const double INF = std::numeric_limits<double>::infinity();
  *remaining_mem = -1;
  const int budget = max_mem - 1 - other_mem;
  if (budget < 0) return INF;
  const double* row = f + static_cast<int64_t>(budget) * strategy_num;
  int next = static_cast<int>(std::min_element(row, row + strategy_num) - row);
  double total = row[next];
  if (!(total < INF)) return INF;
  int v = budget;
  res[layer_num - 1] = next;
  for (int i = layer_num - 1; i > 0; --i) {
    const int cur = next;
    next = mark[(static_cast<int64_t>(i) * max_mem + v) * strategy_num + next];
    v -= v_data[i * strategy_num + cur];
    res[i - 1] = next;
  }
  *remaining_mem = v - v_data[0 * strategy_num + next];
  return total;
}

}  // extern "C"
