"""spumoni_tpu_torch — the PyTorch/CUDA port of spumoni_tpu for NVIDIA Hopper.

The port runs `build`, `import-ref` and `run` (PML and MS, classification,
document tracking, `-m` / `-a` digestion, general text) on one GPU. Its
device work is hand-written CUDA kernels (`engine/kernels.py`, sources in
`csrc/`) over the block-bits, layered and occ-block index layouts, and the
decode of the 2- and 4-bit packed read rows that staging uploads.

Index construction, FASTA/FASTQ parsing, minimizer digestion, the native
C++ binding, the null database and the report writers are the port's own
copies of the JAX package's host modules (`native`, `io/`, `index/`,
`classify/`, the build half of `pipeline`), under the same names. The
native library is compiled from the repository's `native/` source into
this package's `_build/`. Nothing in this package imports JAX or the JAX
package.
"""

__version__ = "0.1.0"
