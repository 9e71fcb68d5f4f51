"""Times the scans that are being redesigned for the card at the lane
counts the runs launch, each beside another tree's build of the same entry
points, with controls whose step the redesigns must leave as it was.

    python -m spumoni_tpu_torch.scripts.time_scan --parent DIR \
        [--families pml,bbclassify,classify,lclassify_tp,occclassify,ms,
                    layered,occ,extend,staging,chase,grouped] \
        [--ablate] [--graph] \
        [--shapes 8192,32768,65536] [--out DIR]

Run from the repository root on a machine with one NVIDIA GPU. It writes
chip_smoke.py's inputs (10 strains, 65,536 reads of 1,024 bp) into
chip_smoke_work/, builds phase 4b's MS + doc index (`build -i list -M -P
-d -n`; with the layered or classify family also 4c's `build -m -P`) and
stages the reads once per engine; a launch at B lanes takes the first B
of them (value runs launch 8,192, report-only runs 32,768, chip_smoke.py's
tables 65,536). Per shape, CUDA-event ms per call (a warm-up, then 5
calls) of each kernel in turns with the same entry point built from DIR's
`spumoni_tpu_torch/csrc` (parent, current, current, parent; every turn is
printed), outputs equal (max |err| 0):

  * controls (`CONTROLS`), timed whatever the families: K1 `pml_scan` on
    the index's block-bits PML rows, K3 `ms_scan` in each mode and K15
    `ms_scan_tp` (ms+doc, 4 shards) on its MS + doc rows (K1, K2 and K13
    share their step, csrc/ms_step.cuh), K7 `layered_scan` (pml, ms+doc)
    on its layered MS + doc tables, K8 `layered_classify` (the bin-max
    carry on K7's step) on its layered PML tables, K9 `occ_scan` (pml) on
    its occ-block PML rows
    (`--engine occ`), K5 `binmax_values` on the MS lengths of K3's ms
    pointers (K4's source);
  * family lclassify_tp: K14 `layered_classify_tp` (4 shards) on the
    layered PML tables;
  * family occclassify: K10 `occ_classify` on the occ-block PML rows (P =
    128, W = T0 + P);
  * family pml: K1 `pml_scan` on the block-bits PML rows;
  * family bbclassify: K2 `pml_classify` and K13 `pml_classify_tp` (4
    shards) on the block-bits PML rows;
  * family classify: K8 `layered_classify` on the layered PML tables,
    and on the -m index at its digested reads' largest bucket (that
    bucket's lanes only);
  * family ms: K3 `ms_scan` in each mode (ms, ms+doc, pml+doc) and K15
    `ms_scan_tp` on 4 shards (ms, ms+doc);
  * family layered: K7 `layered_scan` in each mode (pml, pml+doc, ms,
    ms+doc) on the MS + doc tables (D = 4, W = 8), and K7 pml on the -m
    index's bucket;
  * family occ: K9 `occ_scan` in each mode on the rows of the phase-4d run
    that uses it (chip_smoke.OCC_TIMED: W = T0 + P, T0 + 3P, T0 + 3P,
    T0 + 5P);
  * family extend: K4 `ms_extend` on K3's ms pointers over the MS + doc
    index (the pointers K7 and K9 give too) and K16 `ms_extend_tp` on the
    same pointers over its text in 4 shards; also, each at its own lanes,
    on long reads (the same strains, reads of 8,192 and 16,384 bp made as
    chip_smoke.make_inputs makes the 1,024-bp ones; a run's batch of
    batch_bases holds 4,096 and 2,048 of them) at int32 and int64
    pointers (LONG_READS): the rows that take the opt-in shared memory or
    the unstaged walk;
  * family grouped: a value batch of 2,048 whole reads of the value
    cells' lengths (GROUPED_LENGTH: gamma, mean 15 kbp, one multiset)
    over the strains, staged as the engine stages it, every group decoded
    once: K1 `pml_scan` on the block-bits PML rows, and K3 `ms_scan`
    (ms+doc) then K4 `ms_extend` on its pointers, on the MS + doc rows, in
    one grouped launch each against one launch a staged group, back to
    back on the stream (`Case.parent_call`, the rows `per-group`), both on
    this tree's build: a one-group launch is the matrix form, whose code
    the controls hold to the parent's; outputs equal read by read
    (`Case.compare`);
  * family staging: K11 `unpack2` on the reads' 2-bit rows as staged (no
    exceptions) and, at the largest shape only, on the same reads with 1
    in 128 bytes set to N (its exceptions name rows of the whole batch),
    and K12 `unpack4` on the same reads at 4 bits in staged-alphabet
    ranks, plain and through the alphabet's byte table (chip_smoke.py's
    phase 5e's inputs);
  * family chase: K6 `gather_chase` at exp_vmem_gather's shape (R =
    9,728, W = 128, 64 steps, `make_inputs(0)`), and a latency probe: the
    table's first column alone ([9,728, 1], one wave of chains) at 64 and
    1,024 steps, whose difference over 960 steps is one step's latency in
    the table's home. Each call launches the kernel on inputs checked once
    (`_chase_calls`): the wrapper's range check reads idx0's minimum and
    maximum back to the host, a synchronisation that would sit in the
    events' window and break the graph's capture. The libraries built from
    DIR's sources (its own and its ablations) are called with the
    argument list of ca6334c's entry point (`Case.parent_call`), which
    takes no remainder multiplier and no column count (`PARENT_ARGS`).

With --graph (always on for the staging and chase families), each turn is
also timed with the host's enqueue out of the window: 20 calls captured
once in a CUDA graph and replayed (`graph_ms`, method 'graph'); where
capture fails, the CUDA kernels' summed durations in torch.profiler over
20 calls (method 'profiler'). Without it the other families print what
they did.

With --ablate, each family's timing-only variants run beside the parent:
its ablations (`FAMILIES[...].ablations`), built from patched copies of
DIR's sources, and its variants (`.variants`), built from patched copies
of this tree's (K8's and K2 / K13's other lane group; K4 / K16's other
lane groups, two text windows a round trip, and the unstaged walk for
rows past 48 KB; K14's and K10's other lane group; K11 / K12's other
vector counts a thread, their look-ups by shifts, and each lane storing its
own vector's output; K6's other column groups a block, chains a thread and
threads a block, `%` in place of the host-computed multiplier, no table
copy and the multiplier without the dividend's add, the last two timing
only). An ablation may give wrong answers (its max |err| is reported)
and is never used for anything else. A redesign's baseline and
attribution come first: add its family, with the ablations patched into
the parent's sources, and run the script while this tree's sources are
still the parent's.
An ablation's patches are literal lines of one commit's sources
(`FAMILIES[...].patches`), a variant's of this tree's: on any other
parent --ablate stops with the line it did not find.

A parent's entry point is called through this tree's wrapper: the script
loads DIR's library in place of this tree's for the call
(`kernels._libs`). So DIR's `spumoni_tpu_torch/engine/kernels.py` must
declare the entry points the script calls (`ENTRY_POINTS`) with this
tree's argument lists (its `_SIGNATURES`), or the script stops. Also
writes the SASS of each family's kernels named in `sass_keys` (this
tree's and the parent's) to the --out directory and prints their ptxas
registers and spills and their load / shuffle counts. Everything goes to
--out (JSON); the card's name and power limit head the output. PERF.md
section 6's redesign numbers come from this script.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from ..engine import kernels
from ..parallel import tp

SHARDS = 4
#: chip_smoke.py's strains (write_inputs), which make_inputs draws first
#: from its seed: the long reads below are drawn over the same ones
STRAINS, STRAIN_LEN = 10, 4_600_000
#: chip_smoke.py's reads (write_inputs), staged once per engine as one
#: group: a shape of B lanes takes the first B
READS = 65_536
#: K4 / K16's long-read shapes, (read length, lanes): a run's parse batch
#: of RunConfig.batch_bases (33,554,432) bases holds batch_bases // L reads
LONG_READS = ((8192, 4096), (16384, 2048))
#: library -> the entry points the script calls (through this tree's
#: wrappers): the families' scans and the controls
ENTRY_POINTS = {"blockbits_pml": ("spn_pml_scan", "spn_pml_classify",
                                  "spn_pml_classify_tp"),
                "blockbits_ms": ("spn_ms_scan", "spn_ms_scan_tp",
                                 "spn_ms_extend", "spn_ms_extend_tp",
                                 "spn_binmax_values"),
                "layered": ("spn_layered_scan", "spn_layered_classify",
                            "spn_layered_classify_tp"),
                "occblock": ("spn_occ_scan", "spn_occ_classify"),
                "staging": ("spn_unpack2", "spn_unpack4"),
                "gather_chase": ("spn_gather_chase",)}
#: libraries whose entry points take another argument list in DIR than in
#: this tree: the builds from DIR's sources are called with the cases'
#: parent_call, whose list is that of the commit named
PARENT_ARGS = {"gather_chase": "ca6334c"}
#: (kernel, mode) of the controls, timed whatever the families
CONTROLS = {("pml_scan", "pml"), ("ms_scan", "ms"), ("ms_scan", "ms+doc"),
            ("ms_scan", "pml+doc"), ("ms_scan_tp", "ms+doc"),
            ("layered_scan", "pml"), ("layered_scan", "ms+doc"),
            ("layered_classify", "pml"), ("occ_scan", "pml"),
            ("binmax_values", "ms")}


class Family(NamedTuple):
    library: str      # kernels.LIBRARIES key of the scans' source
    sass_keys: tuple  # (library, kernel name substring) whose SASS is kept
    patches: str      # the commit whose sources `ablations` patch
    ablations: dict   # label -> [(file, text, replacement)]
    variants: dict = {}  # label -> patches of this tree's sources


# --- family ms: K3 / K15, ablations of the one-thread-a-read design -------
_MS_NO_JUMPS = [
    ("blockbits_ms.cu", "ov[-t] = (PosT)(jump_t[jidx] - (PosT)run);",
     "ov[-t] = (PosT)(jidx - (PosT)run);"),
    ("blockbits_ms.cu", "if (MODE != kMs) od[-t] = (PosT)jump_d[jidx];",
     "if (MODE != kMs) od[-t] = (PosT)jidx;"),
    ("blockbits_ms.cu", "ov[-t] = (PosT)(*jump_t.row(jidx, 1) - (PosT)run);",
     "ov[-t] = (PosT)(jidx - (PosT)run);"),
    ("blockbits_ms.cu", "if (MODE != kMs) od[-t] = (PosT)*jump_d.row(jidx, 1);",
     "if (MODE != kMs) od[-t] = (PosT)jidx;")]
_MS_ONE_WORD = [
    ("blockbits_ms.cu", "for (int w = 0; w < wcut; ++w)",
     "for (int w = 0; w < (wcut < 1 ? wcut : 1); ++w)"),
    ("blockbits_pml.cuh", "for (int w = 0; w < wsel; ++w)",
     "for (int w = 0; w < (wsel < 1 ? wsel : 1); ++w)")]

# --- family layered: K7, ablations of the one-thread-a-read design --------
_K7_ONE_PROBE = [
    ("layered.cu", "for (int s = kNode / 2; s > 0; s >>= 1)",
     "for (int s = kNode / 2; s > kNode / 4; s >>= 1)")]
_K7_SLOTS_EARLY = [
    ("layered.cu", "  const long long thr = pad ? 0 : (long long)__ldg(f + kThr);\n",
     "  const long long thr = pad ? 0 : (long long)__ldg(f + kThr);\n"
     "  const long long es_ = (long long)__ldg(f + kEsamp),\n"
     "                  ss_ = (long long)__ldg(f + kSsamp),\n"
     "                  ed_ = (long long)__ldg(f + kEdoc),\n"
     "                  sd_ = (long long)__ldg(f + kSdoc);\n"),
    ("layered.cu", "(long long)__ldg(f + (jump_down ? kSsamp : kEsamp))",
     "(jump_down ? ss_ : es_)"),
    ("layered.cu", "pad ? 0 : (long long)__ldg(f + (jump_down ? kSdoc : kEdoc))",
     "pad ? 0 : (jump_down ? sd_ : ed_)")]
#: (c): the top levels' rows of the characters the index holds, as many
#: levels as fit 48 KB, copied into dynamic shared memory by each block
_K7_STAGE_CODE = r"""
constexpr int kAbBytes = 48 * 1024;
struct AbStage {
  int off[2][256], n[2][256], nst;
};
__device__ __forceinline__ AbStage& ab_stage_info() {
  __shared__ AbStage st;
  return st;
}
__device__ __forceinline__ unsigned char* ab_rows() {
  extern __shared__ __align__(16) unsigned char ab_dyn[];
  return ab_dyn;
}

template <typename T>
__device__ __forceinline__ long long ab_rows_of(const T (*cm)[kMetaCols],
                                                const long long* lv_rows,
                                                int c, int t) {
  return (c < 255 ? (long long)cm[c + 1][4 + t] : lv_rows[t]) -
         (long long)cm[c][4 + t];
}

template <typename T>
__device__ void ab_stage(const T (*cm)[kMetaCols], const T* const* lv,
                         const long long* lv_rows, int depth) {
  AbStage& a = ab_stage_info();
  if (threadIdx.x == 0) {
    long long used = 0;
    a.nst = 0;
    for (int k = 0; k < 2 && k < depth; ++k) {
      const int t = depth - 1 - k;
      long long need = 0;
      for (int c = 0; c < 256; ++c)
        if (cm[c][1] > 0) need += ab_rows_of(cm, lv_rows, c, t);
      if ((used + need) * kNode * (long long)sizeof(T) > kAbBytes) break;
      for (int c = 0; c < 256; ++c) {
        const int n = cm[c][1] > 0 ? (int)ab_rows_of(cm, lv_rows, c, t) : 0;
        a.off[k][c] = (int)used;
        a.n[k][c] = n;
        used += n;
      }
      a.nst = k + 1;
    }
  }
  __syncthreads();
  T* dst = (T*)ab_rows();
  for (int k = 0; k < a.nst; ++k) {
    const int t = depth - 1 - k;
    for (int c = 0; c < 256; ++c)
      for (int i = threadIdx.x; i < a.n[k][c] * kNode; i += blockDim.x)
        dst[(long long)a.off[k][c] * kNode + i] =
            lv[t][(long long)cm[c][4 + t] * kNode + i];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ const T* ab_row(const T (*cm)[kMetaCols],
                                           const T* const* lv, int depth,
                                           int t, long long at, int c) {
  const AbStage& a = ab_stage_info();
  const int k = depth - 1 - t;
  if (k < a.nst) {
    const long long rel = at - (long long)cm[c][4 + t];
    if (rel >= 0 && rel < a.n[k][c])
      return (const T*)ab_rows() + (a.off[k][c] + rel) * kNode;
  }
  return lv[t] + at * kNode;
}

// Per-lane recurrence state.
"""
_K7_STAGE = [
    ("layered.cu", "\n// Per-lane recurrence state.\n", _K7_STAGE_CODE),
    # generic loads: a row may now lie in shared memory
    ("layered.cu", "__ldg(row + m + s - 1)", "row[m + s - 1]"),
    ("layered.cu", "__ldg(row + kNode - 1)", "row[kNode - 1]"),
    ("layered.cu", "const T* row = lv[t] + at * kNode;",
     "const T* row = ab_row(cm, lv, s.depth, t, at, c);"),
    ("layered.cu",
     "                    long long L, T* __restrict__ vals, "
     "T* __restrict__ docs) {\n"
     "  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;\n"
     "  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;\n"
     "  __shared__ T cm[256][kMetaCols];\n"
     "  __shared__ const T* lv[kMaxDepth];\n"
     "  __shared__ long long lv_rows[kMaxDepth];\n"
     "  load_meta(cm, lv, lv_rows, charmeta, levels);\n"
     "  __syncthreads();\n",
     "                    long long L, T* __restrict__ vals, "
     "T* __restrict__ docs) {\n"
     "  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;\n"
     "  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;\n"
     "  __shared__ T cm[256][kMetaCols];\n"
     "  __shared__ const T* lv[kMaxDepth];\n"
     "  __shared__ long long lv_rows[kMaxDepth];\n"
     "  load_meta(cm, lv, lv_rows, charmeta, levels);\n"
     "  __syncthreads();\n"
     "  ab_stage(cm, lv, lv_rows, s.depth);\n"),
    ("layered.cu",
     "void launch_scan(const ScanArgs& a) {\n"
     "  layered_scan_kernel<T, MODE><<<grid_of(a.B), kThreads, 0, "
     "a.stream>>>(",
     "void launch_scan(const ScanArgs& a) {\n"
     "  cudaFuncSetAttribute(layered_scan_kernel<T, MODE>,\n"
     "                       cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                       kAbBytes);\n"
     "  layered_scan_kernel<T, MODE><<<grid_of(a.B), kThreads, kAbBytes, "
     "a.stream>>>(")]

# --- family occ: K9, ablations of the one-thread-a-read design ------------
_K9_ONE_WORD = [
    ("occblock.cu", "for (int w = 0; w < we; ++w)",
     "for (int w = 0; w < (we < 1 ? we : 1); ++w)")]
_K9_CANDIDATES_EARLY = [
    ("occblock.cu", "  const bool minus1 =\n      st.forced ||",
     "  const int sc0_ = kIsMs ? (int)__ldg(row + s.S0 + off) : 0;\n"
     "  const int sc1_ = kIsMs ? (int)__ldg(row + s.S0 + s.P + off) : 0;\n"
     "  const int dc0_ = kDoc ? (int)__ldg(row + s.D0 + off) : 0;\n"
     "  const int dc1_ = kDoc ? (int)__ldg(row + s.D0 + s.P + off) : 0;\n"
     "  const bool minus1 =\n      st.forced ||"),
    ("occblock.cu", ": (int)__ldg(row + s.S0 + (minus1 ? s.P : 0) + off);",
     ": (minus1 ? sc1_ : sc0_);"),
    ("occblock.cu", "doc = (int)__ldg(row + s.D0 + (minus1 ? s.P : 0) + off);",
     "doc = minus1 ? dc1_ : dc0_;")]

# --- family pml: K1, ablation of the one-thread-a-read design -------------
_K1_ONE_WORD = [
    ("blockbits_pml.cuh", "for (int w = 0; w < wsel; ++w)",
     "for (int w = 0; w < (wsel < 1 ? wsel : 1); ++w)")]

# --- family classify: K8, ablation of the one-thread-a-read design --------
# (count_le stays in layered.cu for K14: the same line as K7's ablation)
_K8_ONE_PROBE = _K7_ONE_PROBE
#: K8's other lane group, patched into this tree's source
_K8_G8 = [("layered.cu", "constexpr int kClassifyGroup = 4;",
           "constexpr int kClassifyGroup = 8;")]

# --- family bbclassify: K2 / K13, ablations of the one-thread-a-read scan -
#: (a) spn::probe's character-word loop cut to one word (K2 and K13): the
#: share of the dependent char-word loads
_K2_ONE_WORD = _K1_ONE_WORD
#: (b) no bin-max work (K2 and K13): only the last length is stored, in
#: sum_maxes; what the carry costs
_K2_NO_BINMAX = [
    ("blockbits_pml.cu", "    bins.add(t, length);\n", ""),
    ("blockbits_pml.cu",
     "  bins.finish(found + b, above + b, below + b, sum_maxes + b);",
     "  sum_maxes[b] = length;")]
#: K2 / K13's other lane group, patched into this tree's source
_K2_G8 = [("blockbits_pml.cu", "constexpr int kClassifyGroup = 4;",
           "constexpr int kClassifyGroup = 8;")]

# --- family lclassify_tp: K14, ablations of the one-thread-a-read scan ---
#: (a) count_le cut to one probe (in 393331e only K14 still has it): the
#: share of the descent's upper-bound search
_K14_ONE_PROBE = _K7_ONE_PROBE
#: (b) the field row from shard 0 with no divide: its row there by at most
#: two compare-subtracts (S <= 4 shards of equal size: every read stays in
#: shard 0's allocation); what the shard lookup costs on the chain
_K14_NO_DIVIDE = [
    ("layered.cu", "const T* f = fields.row(pad ? 0 : probe, s.width);",
     "long long q_ = pad ? 0 : probe;\n"
     "  const long long r_ = fields.rows_per_shard;\n"
     "  q_ -= q_ >= 2 * r_ ? 2 * r_ : 0;\n"
     "  q_ -= q_ >= r_ ? r_ : 0;\n"
     "  const T* f = fields.p[0] + q_ * s.width;")]
#: K14's other lane group, patched into this tree's source (K8 shares the
#: constant; only K14 is timed with it)
_K14_G8 = _K8_G8

# --- family occclassify: K10, ablations of the one-thread-a-read scan -----
#: (a) one char word a step (in 393331e K10's advance): the share of the
#: dependent char-word loads
_K10_ONE_WORD = _K9_ONE_WORD
#: (b) no bin-max work: only the last length is stored, in sum_maxes; what
#: the carry costs
_K10_NO_BINMAX = [
    ("occblock.cu", "    bins.add(t, st.length);\n", ""),
    ("occblock.cu",
     "  bins.finish(found + b, above + b, below + b, sum_maxes + b);",
     "  sum_maxes[b] = st.length;")]
#: K10's other lane group, patched into this tree's source
_K10_G8 = [("occblock.cu", "constexpr int kClassifyGroup = 4;",
            "constexpr int kClassifyGroup = 8;")]

# --- family extend: K4 / K16, ablations of the one-thread-a-read walk -----
#: (a) the text byte from the first 1,024 bytes of the text (L1): the
#: share of the random text reads
_K4_TEXT_L1 = [
    ("blockbits_ms.cu",
     "const uint8_t tch = tpos < ntext ? __ldg(text + tpos) : (uint8_t)0;",
     "const uint8_t tch = __ldg(text + (tpos & 1023));"),
    ("blockbits_ms.cu",
     "tpos < ntext ? __ldg(text.row(tpos, 1)) : (uint8_t)0;",
     "__ldg(text.row(tpos & 1023, 1));")]
#: (b) and no pointer loads either (K4 and K16): what the read-byte loads,
#: the stores and the loop cost
_K4_NO_POINTERS = _K4_TEXT_L1 + [
    ("blockbits_ms.cu", "const long long ptr = (long long)pp[i];",
     "const long long ptr = i;")]
#: (c) blocks of 32 threads: the reads of a launch spread over 4x the SMs
_K4_SPREAD = [("blockbits_ms.cu", "constexpr int kThreads = 128;",
               "constexpr int kThreads = 32;")]
#: K4 / K16's other lane groups and two text windows a round trip, patched
#: into this tree's source
#: (the mask of a group smaller than the warp)
_EXTEND_MASK = ("extend_step.cuh",
                """  static_assert(G == 32, "one warp a read");
  return 0xffffffffu;""",
                "  return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1u));")
_K4_G8 = [("blockbits_ms.cu", "constexpr int kExtendGroup = 32;",
           "constexpr int kExtendGroup = 8;"), _EXTEND_MASK]
_K4_G16 = [("blockbits_ms.cu", "constexpr int kExtendGroup = 32;",
            "constexpr int kExtendGroup = 16;"), _EXTEND_MASK]
#: (the second window's 16 staged bytes past the row's end)
_K4_W2 = [
    ("extend_step.cuh",
     """    const uint4 w1 = ta + 16 < tpos + cap ? text.word(ta + 16) : zero4();
    uint64_t tlo, thi, rlo, rhi;
    text16(w0, w1, (int)(t & 15), tlo, thi);
    rd.get16(r + m, rlo, rhi);
    const int f = first_diff(tlo ^ rlo, thi ^ rhi);
    if (f >= cap - m) return cap;
    m += f;
    if (f < 16) return m;""",
     """    const uint4 w1 = ta + 16 < tpos + cap ? text.word(ta + 16) : zero4();
    const uint4 w2 = ta + 32 < tpos + cap ? text.word(ta + 32) : zero4();
    uint64_t tlo, thi, rlo, rhi;
    text16(w0, w1, (int)(t & 15), tlo, thi);
    rd.get16(r + m, rlo, rhi);
    int f = first_diff(tlo ^ rlo, thi ^ rhi);
    text16(w1, w2, (int)(t & 15), tlo, thi);
    rd.get16(r + m + 16, rlo, rhi);
    const int f1 = first_diff(tlo ^ rlo, thi ^ rhi);
    if (f == 16) f += f1;
    if (f >= cap - m) return cap;
    m += f;
    if (f < 32) return m;"""),
    ("extend_step.cuh", "(L + 16 + 24 + 15) / 16 * 16",
     "(L + 16 + 40 + 15) / 16 * 16")]
#: rows past the 48 KB of a default block walked from device memory, not
#: staged in the opt-in shared memory (one block an SM at L = 8,192 int32)
_K4_UNSTAGED_PAST_48K = [("blockbits_ms.cu", "if (smem > optin) {",
                          "if (smem > 48 * 1024) {")]

# --- family staging: K11 / K12, ablations of the one-thread-a-byte decode -
#: (a) the row by a 32-bit divide (exact at every timed shape: B * Q and
#: B * H < 2^32): what the 64-bit divide subroutine costs
_STAGING_DIV32 = [
    ("staging.cu", "const long long row = i / Q;",
     "const long long row = (long long)((unsigned)i / (unsigned)Q);"),
    ("staging.cu", "const long long row = i / H;",
     "const long long row = (long long)((unsigned)i / (unsigned)H);")]
#: (b) no length mask and no lens load (both kernels; wrong bytes past each
#: read): what the load that waits on the divide costs
_STAGING_NO_LENS = [("staging.cu", "const long long len = __ldg(lens + row);",
                     "const long long len = 1LL << 62;")]
#: (c) K11 without its exception scatter launch (wrong bytes at the
#: exceptions' cells): what the second launch costs at the N shape
_K11_NO_SCATTER = [("staging.cu",
                    "  if (k > 0) {\n    scatter_exceptions_kernel",
                    "  if (k < 0) {\n    scatter_exceptions_kernel")]

#: K11 / K12's other vector counts a thread, patched into this tree's source
_STAGING_V1 = [("staging.cu", "constexpr int kVectors = 2;",
                "constexpr int kVectors = 1;")]
_STAGING_V4 = [("staging.cu", "constexpr int kVectors = 2;",
                "constexpr int kVectors = 4;")]
#: each lane's stores on its own vector's output (4 or 2 chunks side by
#: side, one lane's stores 64 or 32 bytes from the next lane's), in place of
#: the part's chunks in turn across the lanes
_STAGING_STRIDED = [("staging.cu", "const int c = xs + g * q;  // chunk of the part",
                     "const int c = xs * D::kOut + q;  // chunk of the part")]
#: the look-ups by shifts of the table words (the parent's way), in place of
#: the byte permutes
_STAGING_SHIFTS = [
    ("staging.cu", """    // the codes of bytes 0 and 2 (then 1 and 3) into selector nibbles
    uint32_t e = p & 0x00FF00FFu, o = (p >> 8) & 0x00FF00FFu;
    e = (e | (e << 4)) & 0x0F0F0F0Fu;
    o = (o | (o << 4)) & 0x0F0F0F0Fu;
    e = (e | (e << 2)) & 0x33333333u;
    o = (o | (o << 2)) & 0x33333333u;
    w[0] = __byte_perm(values, 0, e);
    w[1] = __byte_perm(values, 0, o);
    w[2] = __byte_perm(values, 0, e >> 16);
    w[3] = __byte_perm(values, 0, o >> 16);""",
     """#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (p >> (8 * i)) & 0xFFu;
      uint32_t r = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r |= ((values >> (8 * ((b >> (2 * k)) & 3u))) & 0xFFu) << (8 * k);
      w[i] = r;
    }"""),
    ("staging.cu", """    const uint32_t s = q & 0x7777u;  // a nibble's index in its half
    const uint32_t a = __byte_perm(lo0, lo1, s), b = __byte_perm(hi0, hi1, s);
    // byte k from b where nibble k has bit 3 set, else from a
    return __byte_perm(a, b, 0x3210u | ((q >> 1) & 0x4444u));""",
     """    const unsigned long long lo = (unsigned long long)lo1 << 32 | lo0,
                             hi = (unsigned long long)hi1 << 32 | hi0;
    uint32_t r = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t nib = (q >> (4 * k)) & 15u;
      r |= (uint32_t)((nib < 8 ? lo : hi) >> (8 * (nib & 7u)) & 0xFFu)
           << (8 * k);
    }
    return r;""")]

# --- family chase: K6, ablations of the one-thread-an-element chase -----
#: (a) the remainder by a multiplier and shift computed on the host (in the
#: entry point: the argument list stays ca6334c's) in place of `%`: what
#: the divide costs while the table is read through L2
_K6_MAGIC = [
    ("gather_chase.cu",
     "const int32_t* __restrict__ idx0, int R, int W, int steps,",
     "const int32_t* __restrict__ idx0, int R, int W, int steps,\n"
     "                    unsigned magic_, int shift_,"),
    ("gather_chase.cu", "    idx = a % R;",
     "    const unsigned u_ = (unsigned)a;\n"
     "    const unsigned r_ =\n"
     "        u_ - (unsigned)R * ((__umulhi(u_, magic_) + u_) >> shift_);\n"
     "    idx = a < 0 ? -(int)r_ : (int)r_;"),
    ("gather_chase.cu", "  if (n == 0) return 0;\n",
     "  if (n == 0) return 0;\n"
     "  int shift_ = 0;\n"
     "  while ((1LL << shift_) < R) ++shift_;\n"
     "  const unsigned magic_ = (unsigned)(\n"
     "      ((1ULL << (32 + shift_)) + R - 1) / R - (1ULL << 32));\n"),
    ("gather_chase.cu",
     "(const uint32_t*)table, (const int32_t*)idx0, R, W, steps,",
     "(const uint32_t*)table, (const int32_t*)idx0, R, W, steps, magic_,\n"
     "      shift_,")]
#: (b) the same threads column-major: a warp takes 32 rows of one column,
#: the table still read through L2
_K6_COLUMN_MAJOR = [
    ("gather_chase.cu", "  const int j = (int)(e % W);\n  int idx = idx0[e];",
     "  const int j = (int)(e / R);\n"
     "  const long long ij_ = (e % R) * W + j;\n"
     "  int idx = idx0[ij_];"),
    ("gather_chase.cu", "  out[e] = idx;", "  out[ij_] = idx;")]
#: K6's other column groups a block, chains a thread and threads a block,
#: and `%` in place of the host-computed multiplier, patched into this
#: tree's source
_K6_C1 = [("gather_chase.cu", "    return launch<kCols>(t, i0,",
           "    return launch<1>(t, i0,")]
_K6_C2 = [("gather_chase.cu", "    return launch<kCols>(t, i0,",
           "    return launch<2>(t, i0,"),
          ("gather_chase.cu", "struct Row<4> { using T = uint4; };\n",
           "struct Row<4> { using T = uint4; };\n"
           "template <>\nstruct Row<2> { using T = uint2; };\n")]
_K6_K1 = [("gather_chase.cu", "constexpr int kChains = 2;",
           "constexpr int kChains = 1;")]
_K6_K4 = [("gather_chase.cu", "constexpr int kChains = 2;",
           "constexpr int kChains = 4;")]
_K6_T512 = [("gather_chase.cu", "constexpr int kThreads = 1024;",
             "constexpr int kThreads = 512;")]
_K6_MOD = [("gather_chase.cu",
            "return u + neg_r * ((__umulhi(u, magic) + u) >> shift);",
            "return u % (unsigned)R;")]
#: timing only: no table copy (the chains read whatever shared memory
#: holds): what the copy costs
_K6_NO_COPY = [
    ("gather_chase.cu", "if (cw == C && W % C == 0 &&",
     "if (steps < 0 && cw == C && W % C == 0 &&"),
    ("gather_chase.cu", "c < R * cw; c += kThreads", "c < 0; c += kThreads")]
#: timing only: the remainder without the dividend's add, q = umulhi(u,
#: m) >> s with m = ceil(2^(31 + s) / R) (exact for R >= 2, not for R = 1)
_K6_PLAIN_MAGIC = [
    ("gather_chase.cu",
     "return u + neg_r * ((__umulhi(u, magic) + u) >> shift);",
     "return u + neg_r * (__umulhi(u, magic) >> shift);"),
    ("gather_chase.cu", "const Divisor d{R, magic, shift, 0u - (unsigned)R};",
     "const Divisor d{R, (unsigned)(((1ULL << (31 + shift)) + R - 1) / R),\n"
     "                  shift - 1, 0u - (unsigned)R};")]

#: the block-bits kernels at P = 512, pack = 2, not wide (the 10-strain
#: index's layout)
_P512 = "ILi512ELi2ELb0E"

FAMILIES = {
    "pml": Family(
        "blockbits_pml",
        (("blockbits_pml", f"pml_scan_kernel{_P512}E"),
         ("blockbits_ms", f"ms_scan_kernel{_P512}E"),
         ("blockbits_ms", f"ms_scan_tp_kernel{_P512}E")),
        "53ecd9b",
        {"k1-a-one-char-word": _K1_ONE_WORD}),
    "bbclassify": Family(
        "blockbits_pml",
        (("blockbits_pml", f"pml_classify_kernel{_P512}E"),
         ("blockbits_pml", f"pml_classify_tp_kernel{_P512}E")),
        "2576595",
        {"k2-a-one-char-word": _K2_ONE_WORD,
         "k2-b-no-binmax": _K2_NO_BINMAX},
        {"k2-g8": _K2_G8}),
    "classify": Family(
        "layered",
        (("layered", "layered_classify_kernelIiE"),   # int32 positions
         ("layered", "layered_classify_kernelIxE"),   # int64
         ("layered", "layered_classify_tp_kernelIiE"),
         ("layered", "layered_scan_kernelIiLi0EE")),  # K7 pml
        "53ecd9b",
        {"k8-a-one-level-probe": _K8_ONE_PROBE},
        {"k8-g8": _K8_G8}),
    "lclassify_tp": Family(
        "layered",
        (("layered", "layered_classify_tp_kernelIiE"),  # K14, int32
         ("layered", "layered_classify_kernelIiE"),     # its twin K8
         ("layered", "layered_scan_kernelIiLi0EE")),    # K7 pml: same step
        "393331e",
        {"k14-a-one-probe": _K14_ONE_PROBE,
         "k14-b-shard0-no-divide": _K14_NO_DIVIDE},
        {"k14-g8": _K14_G8}),
    "occclassify": Family(
        "occblock",
        (("occblock", "occ_classify_kernel"),           # K10
         ("occblock", "occ_scan_kernelILi0EE")),        # its twin K9, pml
        "393331e",
        {"k10-a-one-char-word": _K10_ONE_WORD,
         "k10-b-no-binmax": _K10_NO_BINMAX},
        {"k10-g8": _K10_G8}),
    "ms": Family(
        "blockbits_ms",
        # dfdde28's ms+doc instance (its mode a template argument),
        # 7b00901's (the mode a runtime argument) and K15's
        (("blockbits_ms", f"ms_scan_kernel{_P512}Li1E"),
         ("blockbits_ms", f"ms_scan_kernel{_P512}E"),
         ("blockbits_ms", f"ms_scan_tp_kernel{_P512}E")),
        "dfdde28",
        {"a-no-jump-reads": _MS_NO_JUMPS,
         "b-one-word-ranks": _MS_ONE_WORD,
         "c-both": _MS_NO_JUMPS + _MS_ONE_WORD,
         "d-32-thread-blocks": [("blockbits_ms.cu",
                                 "constexpr int kThreads = 128;",
                                 "constexpr int kThreads = 32;")]}),
    "layered": Family(
        "layered",
        (("layered", "layered_scan_kernelIiLi3EE"),),   # int32, ms+doc
        "7b00901",
        {"a-one-level-probe": _K7_ONE_PROBE,
         "b-slots-before-jump": _K7_SLOTS_EARLY,
         "c-top-levels-in-smem": _K7_STAGE}),
    "occ": Family(
        "occblock",
        (("occblock", "occ_scan_kernelILi3EE"),),       # ms+doc
        "7b00901",
        {"a-one-char-word": _K9_ONE_WORD,
         "b-candidates-before-minus1": _K9_CANDIDATES_EARLY,
         "c-both": _K9_ONE_WORD + _K9_CANDIDATES_EARLY}),
    "extend": Family(
        "blockbits_ms",
        # 71e6123's one-thread walks (int32 pointers), this tree's staged
        # group walks (int32; K4 also int64) and K4's unstaged ones
        (("blockbits_ms", "ms_extend_kernelIiE"),
         ("blockbits_ms", "ms_extend_tp_kernelIiE"),
         ("blockbits_ms", "ms_extend_kernelIiLb1EE"),
         ("blockbits_ms", "ms_extend_tp_kernelIiLb1EE"),
         ("blockbits_ms", "ms_extend_kernelIxLb1EE"),
         ("blockbits_ms", "ms_extend_kernelIiLb0EE"),
         ("blockbits_ms", "ms_extend_kernelIxLb0EE")),
        "71e6123",
        {"k4-a-text-in-l1": _K4_TEXT_L1,
         "k4-b-no-pointer-loads": _K4_NO_POINTERS,
         "k4-c-32-thread-blocks": _K4_SPREAD},
        {"k4-g8": _K4_G8, "k4-g16": _K4_G16, "k4-w2": _K4_W2,
         "k4-unstaged-past-48k": _K4_UNSTAGED_PAST_48K}),
    "staging": Family(
        "staging",
        (("staging", "unpack2_kernel"),
         ("staging", "scatter_exceptions_kernel"),
         ("staging", "unpack4_kernel")),
        "7457b81",
        {"a-32-bit-divide": _STAGING_DIV32,
         "b-no-lens": _STAGING_NO_LENS,
         "c-no-scatter": _K11_NO_SCATTER},
        {"v1": _STAGING_V1, "v4": _STAGING_V4,
         "shift-lookup": _STAGING_SHIFTS,
         "lane-strided-stores": _STAGING_STRIDED}),
    "chase": Family(
        "gather_chase",
        (("gather_chase", "gather_chase_kernel"),),
        "ca6334c",
        {"k6-a-host-remainder": _K6_MAGIC,
         "k6-b-column-major": _K6_COLUMN_MAJOR},
        {"k6-c1": _K6_C1, "k6-c2": _K6_C2, "k6-k1": _K6_K1, "k6-k4": _K6_K4,
         "k6-t512": _K6_T512, "k6-mod": _K6_MOD, "k6-no-copy": _K6_NO_COPY,
         "k6-plain-magic": _K6_PLAIN_MAGIC}),
    "grouped": Family("blockbits_ms", (), "", {}),
}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def parent_signatures(parent: str, libraries) -> dict:
    """{library: {entry point: argtypes}} of ENTRY_POINTS as DIR's
    kernels.py declares them (`_SIGNATURES`); stops unless they are this
    tree's, but for the libraries of PARENT_ARGS."""
    path = os.path.join(parent, "spumoni_tpu_torch", "engine", "kernels.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "_SIGNATURES"
                        for t in n.targets))
    # its ctypes names (_P, _I32, ...) as this tree's kernels.py binds them
    sigs = eval(compile(ast.Expression(node), path, "eval"),
                dict(vars(kernels)))
    out = {}
    for lib in libraries:
        ours = kernels._SIGNATURES[lib]
        if lib in PARENT_ARGS:
            out[lib] = {fn: sigs[lib][fn] for fn in ENTRY_POINTS[lib]}
            continue
        for fn in ENTRY_POINTS[lib]:
            if sigs.get(lib, {}).get(fn) != ours[fn]:
                raise SystemExit(f"time_scan: the parent's {fn} takes other "
                                 f"arguments than this tree's; this script "
                                 f"calls it through this tree's")
        out[lib] = {fn: ours[fn] for fn in ENTRY_POINTS[lib]}
    return out


def build_variants(jobs, signatures) -> dict:
    """nvcc of each job's library from a copy of a csrc directory (job =
    (label, library, patches, csrc): 'parent' and 'current' unpatched),
    all at once, into kernels.BUILD_DIR/lab-<label>-<library>/; bound
    with `signatures` (the parent's), or this tree's where csrc is this
    tree's. Returns {(label, library): (CDLL, .so path, nvcc's
    output)}."""
    procs, csrcs = {}, {}
    for label, library, patches, csrc in jobs:
        csrcs[label, library] = csrc
        if (label, library) in procs:
            raise ValueError(f"two builds of {library} labelled {label}")
        d = os.path.join(kernels.BUILD_DIR, f"lab-{label}-{library}")
        os.makedirs(d, exist_ok=True)
        for name in os.listdir(csrc):
            with open(os.path.join(csrc, name)) as f:
                src = f.read()
            for fname, old, new in patches:
                if fname == name:
                    if old not in src:
                        raise RuntimeError(
                            f"{label}: {old!r} not in {name} (the ablations "
                            f"patch one commit's sources)")
                    src = src.replace(old, new)
            with open(os.path.join(d, name), "w") as f:
                f.write(src)
        so = os.path.join(d, f"lib{library}.so")
        procs[label, library] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(d, kernels.LIBRARIES[library])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(so)
        sigs = kernels._SIGNATURES if csrcs[key] == kernels._CSRC \
            else signatures
        for fn in ENTRY_POINTS[key[1]]:
            argtypes = sigs[key[1]][fn]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = (lib, so, log)
    return libs


@contextlib.contextmanager
def _library(name: str, lib):
    """Inside the block, kernels.library(name) is `lib` (None: this
    tree's), so the wrappers launch its entry points."""
    kernels.library(name)
    saved = kernels._libs[name]
    if lib is not None:
        kernels._libs[name] = lib
    try:
        yield
    finally:
        kernels._libs[name] = saved


def _time(fn, reps=5):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


#: calls captured in one CUDA graph (--graph)
GRAPH_CALLS = 20


def graph_time(fn, calls=GRAPH_CALLS, replays=5):
    """(method, ms a call) with the host's enqueue out of the window:
    `calls` calls captured once in a CUDA graph (the wrappers launch on the
    current stream, the capture stream) and replayed, a warm-up and then
    `replays` between CUDA events ('graph'); where capture fails, the CUDA
    kernels' summed durations in torch.profiler over `calls` calls
    ('profiler')."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return "profiler", _profiler_time(fn, calls)
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return "graph", a.elapsed_time(b) / (replays * calls)


def _profiler_time(fn, calls) -> float:
    """ms a call: the CUDA kernels' durations torch.profiler records over
    `calls` calls, summed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / calls


def _err(got, want) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want) if g is not None)


def sass_of(so: str, key: str) -> str:
    """The SASS of the one kernel of `so` whose name holds `key`."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so], check=True,
                         capture_output=True, text=True).stdout
    funcs = out.split("\t\tFunction : ")
    hits = [f for f in funcs[1:] if key in f.splitlines()[0]]
    return hits[0] if hits else ""


def ptxas_of(log: str, key: str) -> list:
    """ptxas -v's lines (properties, registers) for the kernels whose name
    holds `key`."""
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and key in ln:
            keep += [ln.strip()] + [x.strip() for x in lines[i + 1:i + 4]
                                    if "Compiling entry" not in x]
    return keep


def summarize_sass(sass: str) -> dict:
    """Counts of global loads / stores / shuffles / branches in the SASS."""
    ops = []
    for ln in sass.splitlines():
        parts = ln.split("*/")
        if len(parts) > 1 and parts[1].strip().rstrip(" ;"):
            op = parts[1].strip()
            ops.append(op.split(" ", 1)[1] if op.startswith("@") else op)
    count = lambda p: sum(1 for o in ops if o.startswith(p))  # noqa: E731
    return dict(instructions=len(ops), ldg=count("LDG"), stg=count("STG"),
                shfl=count("SHFL"), bra=count("BRA"), lds=count("LDS"))


class Case(NamedTuple):
    kernel: str
    mode: str
    family: str        # FAMILIES key, or 'control'
    library: str
    call: object       # call(B) -> outputs, B None for the case's own lanes
    own_lanes: int = 0  # > 0: timed once, at these lanes (the -m bucket)
    #: call(B) for the builds from DIR's sources (PARENT_ARGS), or the
    #: per-group side of family grouped, else None
    parent_call: object = None
    #: compare(got, want) -> max |err| of the two calls' outputs, where
    #: they differ in form (family grouped), else None: _err
    compare: object = None


def _cut(t, B):
    return t if B is None else t[:B].contiguous()


def _m_bucket(dev, reads, top):
    """4c's -m index (built here) and its digested reads' largest bucket,
    decoded: (engine, staged group)."""
    import chip_smoke as cs
    from .. import cli, pipeline
    from ..io.fastx_batch import iter_packed_batches
    from ..io.minimizers import digest_packed

    t0 = time.time()
    cli.main(cs._build_args()["-m -P"])
    mx = pipeline.make_engine(os.path.join(cs.WORK, "idx-m")
                              + ".bin.thrbv.spumoni", dev)
    pk = digest_packed(next(iter_packed_batches(reads, 1 << 40, upper=True)),
                       True, False)
    g = cs._decoded(mx, max(mx.stage(pk, max_lanes=top),
                            key=lambda grp: len(grp["idxs"])))
    print(f"-m index and its bucket (B={g['rev_d'].shape[0]}, "
          f"L={g['rev_d'].shape[1]}) in {time.time() - t0:.1f} s",
          flush=True)
    return mx, g


def _staging_cases(engine, reads) -> list:
    """Family staging's calls, on `engine`'s staging of the reads as
    chip_smoke.py's phase 5e makes it: K11 on the 2-bit rows as staged (no
    exceptions; the first B rows) and on the same reads with 1 in 128
    bytes set to N (READS lanes only: the exceptions name rows of the
    whole batch); K12 on the reads packed at 4 bits in staged-alphabet
    ranks, through the alphabet's byte table and plain."""
    import numpy as np

    from ..engine.scan_engine import _alpha_table
    from ..io.fastx_batch import PackedReads, iter_packed_batches
    from ..native import pack_rows_native

    pk = next(iter_packed_batches(reads, 1 << 40, upper=True))
    (g,) = engine.stage(pk, max_lanes=READS)
    sel = g["idxs"]
    p4 = torch.from_numpy(pack_rows_native(
        pk.buf, pk.offs[sel], pk.offs[sel + 1], len(sel), g["L"],
        engine._stage_amap, False, 4)[0]).to(engine.device)
    buf = pk.buf.copy()
    buf[np.random.default_rng(1500).random(len(buf)) < 1 / 128] = ord("N")
    (gn,) = engine.stage(PackedReads(pk.ids, buf, pk.offs),
                         max_lanes=READS)
    if (g["bits"], gn["bits"]) != (2, 2) or g["exc_d"] is not None \
            or gn["exc_d"] is None:
        raise AssertionError("the reads did not stage at 2 bits, without "
                             "exceptions and with them under 1/128 N")
    print(f"staging: B={len(sel)} L={g['L']}, 1/128 N: "
          f"{gn['exc_d'].shape[0]} exceptions", flush=True)
    table = _alpha_table(g["alpha"])
    cut = lambda k, B: _cut(g[k], B)  # noqa: E731
    return [
        Case("unpack2", "as staged", "staging", "staging",
             lambda B: kernels.unpack2(cut("rev_p", B), g["ranks2"], None,
                                       cut("lens_d", B))),
        Case("unpack2", "1/128 N", "staging", "staging",
             lambda B: kernels.unpack2(gn["rev_p"], gn["ranks2"],
                                       gn["exc_d"], gn["lens_d"]),
             own_lanes=READS),
        Case("unpack4", "byte table", "staging", "staging",
             lambda B: kernels.unpack4(_cut(p4, B), cut("lens_d", B),
                                       table)),
        Case("unpack4", "plain", "staging", "staging",
             lambda B: kernels.unpack4(_cut(p4, B), cut("lens_d", B)))]


def _chase_calls(table, idx0, steps):
    """(call, parent_call) -> K6's output, on inputs checked here, once:
    call launches this tree's entry point (kernels._chase_launch: the
    remainder's multiplier and shift, the columns a block holds);
    parent_call launches ca6334c's (PARENT_ARGS), whose argument list
    has neither."""
    if kernels._check_chase(table, idx0) != "cuda":
        raise ValueError("the chase family times CUDA tensors")
    R, W = table.shape

    def call(B):
        out = torch.empty_like(idx0)
        kernels._chase_launch(table, idx0, steps, out)
        return out

    def parent_call(B):
        out = torch.empty_like(idx0)
        kernels._raise_on(kernels.library("gather_chase").spn_gather_chase(
            table.data_ptr(), idx0.data_ptr(), R, W, steps, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "gather_chase")
        return out
    return call, parent_call


#: family grouped's read lengths: whole nanopore reads, gamma with mean
#: 15,000 and sd 13,000 bp clipped to 200-100,000, 2,048 drawn from one
#: seed (the value cells' multiset: 27 length buckets, longest 95,007 bp)
GROUPED_LENGTH = dict(reads=2048, mean=15000, sd=13000, min=200, max=100000,
                      seed=20231017)


def grouped_lengths():
    """Family grouped's 2,048 read lengths (GROUPED_LENGTH)."""
    import numpy as np

    p = GROUPED_LENGTH
    shape, scale = (p["mean"] / p["sd"]) ** 2, p["sd"] ** 2 / p["mean"]
    r = np.random.default_rng(p["seed"])
    return np.clip(np.rint(r.gamma(shape, scale, size=p["reads"])),
                   p["min"], p["max"]).astype(np.int64)


def _grouped_reads(work: str, seed: int = 1) -> str:
    """A read FASTA of grouped_lengths' reads over chip_smoke.py's strains:
    even reads substrings of a random strain with 8% substitutions, odd
    reads random; returns its path."""
    import numpy as np

    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    with open(os.path.join(work, "pangenome.fa"), "rb") as f:
        strains = [np.frombuffer(line, np.uint8) for line in
                   f.read().split(b"\n")[1::2] if line]
    path = os.path.join(work, "grouped_reads.fa")
    with open(path, "wb") as f:
        for i, m in enumerate(int(x) for x in grouped_lengths()):
            if i % 2:
                rd = rng.choice(cs.ACGT, size=m)
            else:
                text = strains[rng.integers(len(strains))]
                st = int(rng.integers(0, len(text) - m))
                rd = text[st:st + m].copy()
                mut = rng.random(m) < 0.08
                rd[mut] = rng.choice(cs.ACGT, size=int(mut.sum()))
            f.write(b">r%d\n" % i + rd.tobytes() + b"\n")
    return path


def _grouped_compare(staged):
    """compare(got, want) of family grouped: a grouped launch's flat
    outputs against one launch a group's [B, L] outputs (a list, a tuple a
    group), read by read at the lanes' offsets."""
    def compare(got, want):
        got = got if isinstance(got, tuple) else (got,)
        err = 0
        for k, flat in enumerate(got):
            if flat is None:
                continue
            for g, mats in zip(staged, want):
                mat = (mats if isinstance(mats, tuple) else (mats,))[k]
                for j, (o, n) in enumerate(zip(g["offs"], g["lens"])):
                    err = max(err, _err(flat[o:o + n], mat[j, :n]))
        return err
    return compare


def _grouped_cases(pml, msx, reads) -> list:
    """Family grouped: the value batch of `reads` staged by each engine,
    its rows decoded once, K1 and K3 (ms+doc) then K4 in one grouped
    launch each (call) and in one launch a staged group (parent_call)."""
    from ..io.fastx_batch import iter_packed_batches

    pk = next(iter_packed_batches(reads, 1 << 40, upper=True))
    cases = []
    for engine in (pml, msx):
        staged = engine.stage(pk, 8192)
        lanes, index = staged[0]["lanes"], engine.index
        tab = staged[0]["tab"]
        rev = engine._flat_rows(staged, engine._rev_d)
        revs = [engine._rev_d(g) for g in staged]
        label = f"{len(staged)} groups"
        if engine.mode == "pml":
            cases.append(Case(
                "pml_scan", label, "grouped", "blockbits_pml",
                lambda B, rev=rev, lanes=lanes, tab=tab, index=index:
                kernels.pml_scan(index, tab, rev, lanes),
                own_lanes=len(pk),
                parent_call=lambda B, revs=revs, staged=staged, tab=tab,
                index=index: [kernels.pml_scan(index, tab, r, g["lens_d"])
                              for r, g in zip(revs, staged)],
                compare=_grouped_compare(staged)))
            continue
        fwd = engine._flat_rows(staged, engine._fwd_d)
        fwds = [engine._fwd_d(g) for g in staged]

        def call(B, rev=rev, fwd=fwd, lanes=lanes, tab=tab, index=index):
            ptrs, docs = kernels.ms_scan(index, tab, rev, lanes, "ms", True)
            return ptrs, docs, kernels.ms_extend(
                index.text, index.text_bound, fwd, lanes, ptrs)

        def parent_call(B, revs=revs, fwds=fwds, staged=staged, tab=tab,
                        index=index):
            out = []
            for r, f, g in zip(revs, fwds, staged):
                ptrs, docs = kernels.ms_scan(index, tab, r, g["lens_d"],
                                             "ms", True)
                out.append((ptrs, docs, kernels.ms_extend(
                    index.text, index.text_bound, f, g["lens_d"], ptrs)))
            return out
        cases.append(Case("ms_scan+ms_extend", f"ms+doc {label}", "grouped",
                          "blockbits_ms", call, own_lanes=len(pk),
                          parent_call=parent_call,
                          compare=_grouped_compare(staged)))
    return cases


def _chase_cases(dev) -> list:
    """Family chase: K6 at exp_vmem_gather's shape, and the latency probe
    (the table's first column, one wave of chains) at 64 and 1,024
    steps."""
    from . import exp_vmem_gather as xg

    table, idx0 = xg.make_inputs(0, dev)
    col = (table[:, :1].contiguous(), idx0[:, :1].contiguous())
    cases = []
    for (tab, start), steps in (((table, idx0), xg.L), (col, 64),
                                (col, 1024)):
        R, W = tab.shape
        call, parent_call = _chase_calls(tab, start, steps)
        cases.append(Case("gather_chase", f"{R}x{W} L={steps}", "chase",
                          "gather_chase", call, own_lanes=R * W,
                          parent_call=parent_call))
    return cases


def _cases(families, dev, reads, shapes) -> list:
    """The timed calls: each family's kernels and the controls
    (CONTROLS), on the engines and staged reads they run with in
    chip_smoke.py."""
    import chip_smoke as cs

    ms_prefix = os.path.join(cs.WORK, "msidx")
    top = max(shapes)
    cases = []

    def staged(engine):
        g = cs._staged(engine, reads, READS)
        return g, lambda k, B: _cut(g[k], B)

    if "chase" in families:
        cases += _chase_cases(dev)
    pml = cs._engine(ms_prefix + ".fa.thrbv.spumoni", dev)
    gp, cp = staged(pml)
    pml_tp = tp.shard_blockbits(pml.index, SHARDS)
    cases += [
        Case("pml_scan", "pml", "pml", "blockbits_pml",
             lambda B: kernels.pml_scan(pml.index, gp["tab"], cp("rev_d", B),
                                        cp("lens_d", B))),
        Case("pml_classify", "pml", "bbclassify", "blockbits_pml",
             lambda B: kernels.pml_classify(pml.index, gp["tab"],
                                            cp("rev_d", B), cp("lens_d", B),
                                            7, cs.BIN_WIDTH)),
        Case("pml_classify_tp", "pml", "bbclassify", "blockbits_pml",
             lambda B: kernels.pml_classify_tp(pml_tp, gp["tab"],
                                               cp("rev_d", B),
                                               cp("lens_d", B), 7,
                                               cs.BIN_WIDTH))]
    if "staging" in families:
        cases += _staging_cases(pml, reads)
    msx = cs._engine(ms_prefix + ".fa.thrbv.ms", dev, "ms", use_doc=True)
    gm, cm = staged(msx)
    if "grouped" in families:
        cases += _grouped_cases(pml, msx, _grouped_reads(cs.WORK))
    sharded = tp.shard_blockbits_ms(msx.index, SHARDS)
    for kernel, idx, wrapper, labels in (
            ("ms_scan", msx.index, kernels.ms_scan,
             ("ms", "ms+doc", "pml+doc")),
            ("ms_scan_tp", sharded, kernels.ms_scan_tp, ("ms", "ms+doc"))):
        for label in labels:
            mode, doc = label.split("+")[0], label.endswith("+doc")
            cases.append(Case(
                kernel, label, "ms", "blockbits_ms",
                lambda B, idx=idx, w=wrapper, mode=mode, doc=doc: w(
                    idx, gm["tab"], cm("rev_d", B), cm("lens_d", B), mode,
                    doc)))
    # K3's ms pointers (this tree's build) and K4's lengths of them, at the
    # largest shape: K4 / K16 and K5 take their first B rows
    ptrs = kernels.ms_scan(msx.index, gm["tab"], gm["rev_d"], gm["lens_d"],
                           "ms", False)[0]
    mslen = kernels.ms_extend(msx.index.text, msx.index.text_bound,
                              gm["fwd_d"], gm["lens_d"], ptrs)
    cases += [
        Case("ms_extend", "ms", "extend", "blockbits_ms",
             lambda B: kernels.ms_extend(msx.index.text,
                                         msx.index.text_bound,
                                         cm("fwd_d", B), cm("lens_d", B),
                                         _cut(ptrs, B))),
        Case("ms_extend_tp", "ms", "extend", "blockbits_ms",
             lambda B: kernels.ms_extend_tp(sharded.text, sharded.text_bound,
                                            cm("fwd_d", B), cm("lens_d", B),
                                            _cut(ptrs, B))),
        Case("binmax_values", "ms", "control", "blockbits_ms",
             lambda B: kernels.binmax_values(_cut(mslen, B), cm("lens_d", B),
                                             7, cs.BIN_WIDTH))]
    for L, lanes in LONG_READS if "extend" in families else ():
        work = os.path.join(cs.WORK, f"long-{L}")
        os.makedirs(work, exist_ok=True)
        _, path = cs.make_inputs(work, STRAINS, STRAIN_LEN, lanes, L)
        g = cs._staged(msx, path, lanes)
        p32 = kernels.ms_scan(msx.index, g["tab"], g["rev_d"], g["lens_d"],
                              "ms", False)[0]
        for p in (p32, p32.long()):
            label = f"ms L={L} " + ("int64" if p.dtype == torch.int64
                                    else "int32")
            cases += [
                Case("ms_extend", label, "extend", "blockbits_ms",
                     lambda B, g=g, p=p: kernels.ms_extend(
                         msx.index.text, msx.index.text_bound, g["fwd_d"],
                         g["lens_d"], p), own_lanes=lanes),
                Case("ms_extend_tp", label, "extend", "blockbits_ms",
                     lambda B, g=g, p=p: kernels.ms_extend_tp(
                         sharded.text, sharded.text_bound, g["fwd_d"],
                         g["lens_d"], p), own_lanes=lanes)]
    lay = cs._engine(ms_prefix + ".fa.thrbv.spumoni", dev, engine="layered")
    _, cl = staged(lay)
    lay_tp = tp.shard_layered(lay.index, SHARDS)
    cases += [
        Case("layered_classify", "pml", "classify", "layered",
             lambda B: kernels.layered_classify(lay.index, cl("rev_d", B),
                                                cl("lens_d", B), 7,
                                                cs.BIN_WIDTH)),
        Case("layered_classify_tp", "pml", "lclassify_tp", "layered",
             lambda B: kernels.layered_classify_tp(lay_tp, cl("rev_d", B),
                                                   cl("lens_d", B), 7,
                                                   cs.BIN_WIDTH))]
    lx = cs._engine(ms_prefix + ".fa.thrbv.ms", dev, "ms", use_doc=True,
                    engine="layered")
    _, clx = staged(lx)
    for label in ("pml", "pml+doc", "ms", "ms+doc"):
        mode, doc = label.split("+")[0], label.endswith("+doc")
        cases.append(Case(
            "layered_scan", label, "layered", "layered",
            lambda B, mode=mode, doc=doc: kernels.layered_scan(
                lx.index, clx("rev_d", B), clx("lens_d", B), mode, doc)))
    if {"layered", "classify"} & set(families):
        mx, gmx = _m_bucket(dev, reads, top)
        cases += [
            Case("layered_scan", "-m pml", "layered", "layered",
                 lambda B: kernels.layered_scan(mx.index, gmx["rev_d"],
                                                gmx["lens_d"], "pml", False),
                 own_lanes=gmx["rev_d"].shape[0]),
            Case("layered_classify", "-m pml", "classify", "layered",
                 lambda B: kernels.layered_classify(
                     mx.index, gmx["rev_d"], gmx["lens_d"], 7, cs.BIN_WIDTH),
                 own_lanes=gmx["rev_d"].shape[0])]
    occ = cs._engine(ms_prefix + ".fa.thrbv.spumoni", dev, engine="occ")
    go, co = staged(occ)
    cases.append(Case(
        "occ_classify", "pml", "occclassify", "occblock",
        lambda B: kernels.occ_classify(occ.index, go["tab"], co("rev_d", B),
                                       co("lens_d", B), 7, cs.BIN_WIDTH)))
    for label, path, mode, doc in cs.OCC_TIMED:
        if label == "pml" or "occ" in families:  # K9 pml: a control
            eng = occ if label == "pml" else cs._engine(
                ms_prefix + path, dev, mode, use_doc=doc, engine="occ")
            g, c = staged(eng)
            cases.append(Case(
                "occ_scan", label, "occ", "occblock",
                lambda B, eng=eng, g=g, c=c, mode=mode, doc=doc:
                kernels.occ_scan(eng.index, g["tab"], c("rev_d", B),
                                 c("lens_d", B), mode, doc)))
    return [c for c in cases if c.family in families
            or (c.kernel, c.mode) in CONTROLS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a source tree of the design to compare with (its "
                         "spumoni_tpu_torch/csrc and engine/kernels.py)")
    ap.add_argument("--families", default="ms,layered,occ",
                    help="comma-separated FAMILIES keys")
    ap.add_argument("--ablate", action="store_true",
                    help="also time each family's ablations")
    ap.add_argument("--graph", action="store_true",
                    help="also time each turn by CUDA-graph replay "
                         "(always on for the staging and chase families)")
    ap.add_argument("--shapes", default="8192,32768,65536")
    ap.add_argument("--out", default="scan_timing")
    args = ap.parse_args(argv)
    families = args.families.split(",")
    if not set(families) <= set(FAMILIES):
        ap.error(f"--families: choose from {', '.join(FAMILIES)}")
    if not torch.cuda.is_available():
        print("time_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from .. import cli

    smi = _smi()
    print(f"{smi}; torch {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    shapes = [int(x) for x in args.shapes.split(",")]
    if max(shapes) > READS:
        ap.error(f"--shapes: at most {READS} lanes (the reads written)")
    t0 = time.time()
    kernels.build()
    libraries = sorted(ENTRY_POINTS)
    parent_csrc = os.path.join(args.parent, "spumoni_tpu_torch", "csrc")
    # this tree's libraries of the SASS kept, once more, for their ptxas
    # report (the cached build of kernels.build() has none)
    sass = [key for f in families for key in FAMILIES[f].sass_keys]
    jobs = [("parent", lib, (), parent_csrc) for lib in libraries] + [
        ("current", lib, (), kernels._CSRC)
        for lib in sorted({lib for lib, _ in sass})]
    if args.ablate:
        for f in families:
            fam = FAMILIES[f]
            jobs += [(label, fam.library, patches, parent_csrc)
                     for label, patches in fam.ablations.items()]
            jobs += [(label, fam.library, patches, kernels._CSRC)
                     for label, patches in fam.variants.items()]
    libs = build_variants(jobs, parent_signatures(args.parent, libraries))
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    report = dict(device=smi, torch=torch.__version__, shapes=shapes,
                  parent=args.parent, families=families)
    for lib, key in dict.fromkeys(sass):
        for tree in ("current", "parent"):
            so, log = libs[tree, lib][1:]
            code = sass_of(so, key)
            if not code:
                continue
            with open(os.path.join(args.out, f"{tree}_{key}.sass"),
                      "w") as fh:
                fh.write(code)
            report[f"sass_{tree}_{key}"] = dict(summarize_sass(code),
                                                ptxas=ptxas_of(log, key))
            print(f"{tree} {key}: {report[f'sass_{tree}_{key}']}",
                  flush=True)

    t0 = time.time()
    cs.write_inputs(STRAINS, STRAIN_LEN)
    cli.main(cs._build_args()["-M -P -d"])
    print(f"inputs and MS index in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    cases = _cases(families, dev, os.path.join(cs.WORK, "reads.fa"), shapes)
    print(f"engines and staged reads in {time.time() - t0:.1f} s",
          flush=True)
    results = []

    def row(case, B, variant, ms, err=None, **kw):
        r = dict(kernel=case.kernel, mode=case.mode, B=B, variant=variant,
                 family=case.family if case.family in families
                 else "control", ms=ms, max_abs_err=err, **kw)
        results.append(r)
        print(json.dumps(r), flush=True)

    def timed(case, lib, B, from_parent=False):
        """(event ms, outputs, (graph method, graph ms) or None); lib
        built from DIR's sources where from_parent."""
        call = case.parent_call if from_parent and case.parent_call \
            else case.call
        with _library(case.library, lib):
            ms, out = _time(lambda: call(B))
            graph = args.graph or case.family in ("staging", "chase")
            return ms, out, graph_time(lambda: call(B)) if graph else None

    def graph_kw(*turns):
        """The graph-replay keys of a row from its turns' timings."""
        if turns[0] is None:
            return {}
        return dict(graph_method=turns[0][0],
                    graph_ms=sum(t[1] for t in turns) / len(turns),
                    graph_turns=[t[1] for t in turns])

    for B in shapes:
        for case in cases:
            if case.own_lanes and B != max(shapes):
                continue
            lanes = case.own_lanes or B
            arg = None if case.own_lanes else B
            # family grouped: both sides on this tree's build
            grouped = case.family == "grouped"
            parent = None if grouped else libs["parent", case.library][0]
            p1, want, pg1 = timed(case, parent, arg, True)
            c1, got, cg1 = timed(case, None, arg)
            c2, _, cg2 = timed(case, None, arg)
            p2, _, pg2 = timed(case, parent, arg, True)
            err = (case.compare or _err)(got, want)
            row(case, lanes, "per-group" if grouped else "parent",
                (p1 + p2) / 2, 0, turns=[p1, p2], **graph_kw(pg1, pg2))
            if err:
                raise AssertionError(f"{case.kernel} {case.mode} B={lanes}: "
                                     f"!= parent (max |err| {err})")
            row(case, lanes, "grouped" if grouped else "current",
                (c1 + c2) / 2, err, turns=[c1, c2], **graph_kw(cg1, cg2))
            if case.family in families and args.ablate:
                fam = FAMILIES[case.family]
                for label in (*fam.ablations, *fam.variants):
                    lib = libs[label, case.library][0]
                    ms, got, g = timed(case, lib, arg,
                                       label in fam.ablations)
                    row(case, lanes, label, ms, _err(got, want),
                        patches=fam.patches if label in fam.ablations
                        else "current", **graph_kw(g))
    report["results"] = results
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{smi}\ntime_scan: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
