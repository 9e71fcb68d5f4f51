"""The host layer shared with spumoni_tpu, loaded without JAX.

`spumoni_tpu/__init__.py` imports JAX unconditionally (to enable x64 mode),
and a machine that runs this port need not have JAX installed. The host
modules themselves — index construction, FASTA/FASTQ parsing, minimizer
digestion, the native
C++ library, the null database, classification and report writers — import
only numpy. This module registers a synthetic parent package whose search
path is the `spumoni_tpu/` directory, so those modules load as
`_spumoni_tpu_host.<name>` without running `spumoni_tpu/__init__.py`. They
are shared, not copied: both packages read and write the same index files.

Some `spumoni_tpu.pipeline` functions import JAX lazily (`run`,
`_make_engine`, `_blockbits_eligible`); the port never calls them and
exposes only the JAX-free names below.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys

_PKG = "_spumoni_tpu_host"
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "spumoni_tpu")


def _load(name: str):
    if _PKG not in sys.modules:
        spec = importlib.machinery.ModuleSpec(_PKG, None, is_package=True)
        spec.submodule_search_locations = [_SRC]
        sys.modules[_PKG] = importlib.util.module_from_spec(spec)
    return importlib.import_module(f"{_PKG}.{name}")


constants = _load("constants")
glibc_rand = _load("glibc_rand")
utils = _load("utils")
native = _load("native")
fasta = _load("io.fasta")
fastx_batch = _load("io.fastx_batch")
minimizers = _load("io.minimizers")
index_format = _load("index.format")
null_db = _load("index.null_db")
binmax = _load("classify.binmax")
kstest = _load("classify.kstest")
report = _load("classify.report")
_pipeline = _load("pipeline")

encode_rows = utils.encode_rows
present_chars = utils.present_chars
pack_rows_native = native.pack_rows_native
fastx_extract = native.fastx_extract
format_values = native.format_values
NativeQueryEngine = native.NativeQueryEngine
build_raw_index = native.build_raw_index

BuildConfig = _pipeline.BuildConfig
RunConfig = _pipeline.RunConfig
build = _pipeline.build
import_reference_build = _pipeline.import_reference_build
_prefetched = _pipeline._prefetched
