// The row source of the sharded-index kernels K13-K16 (`run --tp-devices
// S`): an index table cut by rows into S shards of rows_per_shard rows each,
// every shard its own allocation; row r lives in shard r / rows_per_shard.
// This replaces the JAX package's owner-masked local gather plus psum over
// the `model` mesh axis (spumoni_tpu/engine/blockbits.py:707-725,
// engine/layered.py:327-342, parallel/tp.py:242-252,
// engine/scan_engine.py:563-578): with every shard on the card that runs the
// scan, the owner's row is read directly.
//
// The unsharded kernels (K2, K3, K4, K8) read their tables directly: each
// sharded kernel is its twin's body or step with the table reads through a
// ShardedRows (K13 / K15 by spn::shard_at, ms_step.cuh; K14 by ShardFields
// over shard_at, layered_step.cuh; K16 by ShardedText, extend_step.cuh).
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
