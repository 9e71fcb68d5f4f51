"""Behavior-defining constants, mirroring include/spumoni_main.hpp:63-69
and the option-struct defaults (:134-160,233-250)."""

TERMINATOR = 1            # BWT chars <= 1 coerced to this (ms_rle_string.hpp:21,66-68)
NULL_READ_CHUNK = 150     # null-read length (spumoni_main.hpp:65)
NUM_NULL_READS = 800      # downsample point for null-read extraction (:66)
NULL_READ_BOUND = 1000    # hard cap on null reads (:67)
KS_STAT_MS_THR = 0.25     # legacy fixed KS thresholds (:68-69)
KS_STAT_PML_THR = 0.10

DEFAULT_PFP_WINDOW = 10   # PFP sliding window (spumoni_main.hpp:139)
DEFAULT_HASH_MOD = 100    # PFP hash modulus (:140)
DEFAULT_MIN_K = 4         # small minimizer window (:156)
DEFAULT_MIN_W = 11        # large minimizer window (:157)
DEFAULT_BIN_SIZE = 150    # classification bin width (:158)

MIN_BIN_SIZE = 50         # validation bounds (spumoni_main.hpp:228-229)
MAX_BIN_SIZE = 400
