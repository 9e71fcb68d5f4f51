"""spumoni_tpu_torch — the PyTorch/CUDA port of spumoni_tpu for NVIDIA Hopper.

The port runs the PML classification path (`build -P -n`, `run -P [-c]`)
on one GPU. Its device work is two hand-written CUDA kernels over the
block-bits index layout (engine v4 of the JAX package):

  * `pml_scan` — one thread per read walks the backward PML recurrence and
    writes the read's PML lengths in forward order;
  * `pml_classify` — the same walk with the bin-max classification folded
    into the per-thread carry; only per-read verdict summaries are written.

Index construction, FASTA/FASTQ parsing, the null database and the report
writers are the JAX package's host modules, loaded without JAX
(`spumoni_tpu_torch._host`). Nothing in this package imports JAX.
"""

__version__ = "0.1.0"
