// The windowed bin-max classification folded into a right-to-left scan's
// carry, per thread: the carry of spumoni_tpu/parallel/mesh.py::
// _fused_classify_core, shared by K2 `pml_classify` / K13 (block-bits), K8
// `layered_classify` / K14 (layered engine) and K10 `occ_classify`
// (occ-block engine); each keeps it in every lane of a read's group, and
// lane 0 writes the verdict (the plain version: engine/kernels.py::
// _binmax_fold).
//
// Bins are in forward coordinates; nbins = max(len / bin_width, 1), so the
// short tail merges into the last bin (classify/binmax.py). The scan visits
// forward position len-1-t at step t, so bins appear in decreasing order
// and a bin closes when the scan crosses into another one.

#pragma once

#include <cstdint>

namespace spn {

struct BinMax {
  long long thr;
  int len, bin_width, nbins;
  int prev_bin = -1, n_above = 0, n_below = 0;
  long long cur_max = -1, sum = 0;

  __device__ __forceinline__ BinMax(int len_, int bin_width_, long long thr_)
      : thr(thr_), len(len_), bin_width(bin_width_),
        nbins(len_ / bin_width_ < 1 ? 1 : len_ / bin_width_) {}

  // The value of scan step t (forward position len-1-t), t < len.
  __device__ __forceinline__ void add(int t, long long value) {
    int bin = (len - 1 - t) / bin_width;
    bin = bin < nbins - 1 ? bin : nbins - 1;
    if (prev_bin >= 0 && bin != prev_bin) close();
    cur_max = value > cur_max ? value : cur_max;
    prev_bin = bin;
  }

  // Closes the final open bin and writes the read's verdict.
  __device__ __forceinline__ void finish(uint8_t* found, int32_t* above,
                                         int32_t* below,
                                         long long* sum_maxes) {
    if (len > 0) close();
    *found = (n_above > n_below && len > 0) ? 1 : 0;
    *above = n_above;
    *below = n_below;
    *sum_maxes = sum;
  }

 private:
  __device__ __forceinline__ void close() {
    if (cur_max >= thr) ++n_above; else ++n_below;
    sum += cur_max;
    cur_max = -1;
  }
};

}  // namespace spn
