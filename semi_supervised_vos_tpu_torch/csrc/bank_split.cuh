// The split plan of the bank-affinity sweeps (csrc/affinity_bank.cu and
// csrc/affinity_bank_f32.cu): how the (slot, bank tile) sweep of each
// target tile is cut over blocks so that the grid fills the card. Both
// kernels write partial (m, l, acc) per split, which affinity_combine_kernel
// (csrc/affinity_bank.cu) combines.

#pragma once

namespace bank_split {

// Picks the split count that minimises waves x (iterations per block + a
// prologue of ~3) for `tiles` target tiles of `n_iter` iterations each on
// `slots` resident blocks (SMs x the kernel's occupancy).
inline void choose(long long n_iter, long long tiles, long long slots, int max_splits, int* splits,
                   int* iters_per_split) {
  long long best_cost = -1;
  for (long long s = 1; s <= n_iter && s <= max_splits; ++s) {
    const long long ips = (n_iter + s - 1) / s;
    const long long s_eff = (n_iter + ips - 1) / ips;
    const long long waves = (tiles * s_eff + slots - 1) / slots;
    const long long cost = waves * (ips + 3);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *splits = int(s_eff);
      *iters_per_split = int(ips);
    }
  }
}

}  // namespace bank_split
