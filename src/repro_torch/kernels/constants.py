"""Shared constants for the INC (in-network computation) kernel family.

NetRPC semantics (paper §5.2.1): when a switch detects overflow during an
accumulation it writes MAX_INT / MIN_INT as a *sentinel* and forwards the
packet; host agents recognize the sentinel and re-compute the overflowed
lanes in software ("server agent fallback").

We reserve the two extreme int32 values as sentinels and therefore clamp
ordinary saturating arithmetic to the open interval just inside them.
Using a symmetric range (+/- (2**31 - 2)) keeps negation closed.
"""

INT32_MAX = 2**31 - 1          # positive-overflow sentinel (paper: MAX_INT)
INT32_MIN = -(2**31 - 1)       # negative-overflow sentinel (paper: MIN_INT)
SAT_MAX = INT32_MAX - 1        # largest representable non-sentinel value
SAT_MIN = INT32_MIN + 1        # smallest representable non-sentinel value

# the int8 block pack's scale group: one 128-lane row (the reference's TPU
# lane width), and the rows of one tile of the reference's entry point
LANES = 128
DEFAULT_BLOCK_ROWS = 256
