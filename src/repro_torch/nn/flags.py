# Copied from src/repro/nn/flags.py; the port's layer loops are Python loops, so
# unroll_for steers nothing there (nn/recurrent.chunk_for is the port's chunk).
"""Runtime flags for the measurement harness.

``MEASURE`` is set by the dry-run's roofline-measurement compiles only: it
makes inner chunk scans unroll (so XLA cost_analysis counts every chunk —
while bodies are otherwise counted once) and caps the chunk count.  Never on
for real runs.
"""
MEASURE = False
MEASURE_MAX_CHUNKS = 8


def unroll_for(length: int) -> int:
    """Layer-scan unroll factor: XLA cost_analysis counts a while body once,
    so measurement compiles unroll their (1-2 unit deep) stacks."""
    return max(int(length), 1) if MEASURE else 1


def chunk_for(seq: int, default: int = 128) -> tuple[int, bool]:
    """(chunk_len, unroll) for a sequence under current flags."""
    if not MEASURE:
        return (default if seq % default == 0 else seq), False
    chunk = max(default, -(-seq // MEASURE_MAX_CHUNKS))
    while seq % chunk != 0:  # grow to a divisor
        chunk += default
        if chunk >= seq:
            return seq, True
    return chunk, True
