// The row source of the sharded-index kernels K13-K16 (`run --tp-devices
// S`): an index table cut by rows into S shards of rows_per_shard rows each,
// every shard its own allocation; row r lives in shard r / rows_per_shard.
// This replaces the JAX package's owner-masked local gather plus psum over
// the `model` mesh axis (spumoni_tpu/engine/blockbits.py:707-725,
// engine/layered.py:327-342, parallel/tp.py:242-252,
// engine/scan_engine.py:563-578): with every shard on the card that runs the
// scan, the owner's row is read directly.
//
// The unsharded kernels (K2, K3, K4, K8) do not use this header: each
// sharded kernel is its twin's body with the table reads through a
// ShardedRows, and the twins stay as they were.
//
// A ShardedRows is passed to the kernel by value; its pointers sit in the
// kernel's parameter space.

#pragma once

#include <cstdint>

namespace spn {

constexpr int kMaxShards = 16;

// A table in S <= kMaxShards shards of rows_per_shard rows (the last one
// padded), rows of w elements.
template <typename T>
struct ShardedRows {
  const T* p[kMaxShards];
  long long rows_per_shard;

  // Row r: p[r / rows_per_shard] + (r % rows_per_shard) * w.
  __device__ __forceinline__ const T* row(long long r, int w) const {
    const long long s = r / rows_per_shard;
    return p[s] + (r - s * rows_per_shard) * w;
  }

  // The pointer b with b + r * w == row(r, w): what a helper that takes one
  // unsharded table (spn::probe, run_rank) and reads row r of it is given,
  // so that it reads row r of the shards unchanged. Computed on addresses:
  // b may lie before the shard's allocation, only b + r * w is read.
  __device__ __forceinline__ const T* base(long long r, int w) const {
    const long long s = r / rows_per_shard;
    return (const T*)((uintptr_t)p[s] -
                      (uintptr_t)(s * rows_per_shard * w) * sizeof(T));
  }
};

// A ShardedRows from a host array of S shard pointers; false when S is out
// of range or rows_per_shard is not positive.
template <typename T>
inline bool sharded_rows(ShardedRows<T>& out, const void* ptrs, int S,
                         long long rows_per_shard) {
  if (S < 1 || S > kMaxShards || rows_per_shard < 1) return false;
  const long long* p = (const long long*)ptrs;
  for (int i = 0; i < kMaxShards; ++i)
    out.p[i] = i < S ? (const T*)p[i] : nullptr;
  out.rows_per_shard = rows_per_shard;
  return true;
}

// The ShardedRows of another element type over the same shards.
template <typename T, typename U>
inline ShardedRows<T> retype(const ShardedRows<U>& r) {
  ShardedRows<T> out;
  for (int i = 0; i < kMaxShards; ++i) out.p[i] = (const T*)r.p[i];
  out.rows_per_shard = r.rows_per_shard;
  return out;
}

}  // namespace spn
