// A launch's lanes: which read row each lane scans, how many symbols, and
// where its outputs go. K1 `pml_scan`, K3 `ms_scan` and K4 `ms_extend` map
// a lane to (row, length, output) through it at their head; the step
// bodies do not see it.
//
// Two forms, one kernel each:
//   * a [B, L] matrix (rows and offs null): lane b reads row b at b * L,
//     lens[b] symbols clamped to [0, L], and writes its outputs at b * L
//     (the per-group launch of the layered and occ-block engines' MS
//     extension, the report-only MS path and the tests);
//   * a grouped launch (rows and offs set): the lanes of every staged group
//     of a batch on one device, longest first. Lane b reads rows[b] bytes
//     into the launch's flat rows (each group's [B_g, L_g] matrix in turn),
//     lens[b] symbols (at most L, the widest row), and writes its outputs
//     at offs[b] of a flat output that holds each read's values in the
//     batch's read order, with no padding (engine/scan_engine.py::stage).

#pragma once

namespace spn {

struct Lanes {
  const long long* rows;  // each lane's row offset in bytes, or null
  const long long* lens;  // each lane's length
  const long long* offs;  // each lane's first output, or null
  long long B, L;         // lanes; the widest row

  __device__ __forceinline__ long long row(long long b) const {
    return rows ? rows[b] : b * L;
  }
  __device__ __forceinline__ long long off(long long b) const {
    return offs ? offs[b] : b * L;
  }
  __device__ __forceinline__ long long len(long long b) const {
    const long long n = lens[b];
    return n < 0 ? 0 : n > L ? L : n;
  }
};

}  // namespace spn
