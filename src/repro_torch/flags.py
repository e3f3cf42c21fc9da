"""Process-wide toggles, under the reference's names.

SCAN_UNROLL — set by ``unrolled_scans()`` while the accounting tools
(``launch/dryrun.py``, ``launch/roofline_sweep.py``, ``chip_smoke.py``'s
roofline phase, all through ``dryrun.count_cell``) count a step.  The
reference unrolls its ``lax.scan`` loops under it, because XLA's cost
analysis counts a loop's body once whatever its trip count.  The port has
no compiled loop: its loops (``bulk_forward``'s chunks, the GRU and AUGRU
steps, the cross-entropy's sequence chunks, the microbatches of
``train/microbatch.py``, the layers) are eager Python, so a counting
dispatch mode (``roofline.analysis.count``) sees every iteration whether
the flag is set or not.  What the flag does change is the chunks of
``layers/attention.py``'s ``flash_sdpa``, through ``flash_chunks``.

ACCOUNTING_FLASH_CHUNKS — the (query, key) chunks ``flash_sdpa`` takes
while SCAN_UNROLL is set, the reference's.  Its FLOPs do not depend on the
chunks; with the default (256, 512) chunks an eager count of a 4,096-token
step walks 128 chunk pairs a layer and a microbatch, with these it walks
two.  Its bytes do depend on them a little: the running sums are rescaled
once a key chunk.

The reference's ``scan_unroll()`` (the ``unroll`` argument of a
``lax.scan``) and ``SEQ_SPEC`` (a sequence-parallel constraint that no
reference cell sets) have no reader in the port and are not carried.
"""
from __future__ import annotations

import contextlib

SCAN_UNROLL = False

ACCOUNTING_FLASH_CHUNKS = (2048, 4096)


def flash_chunks(default_q: int, default_kv: int) -> tuple[int, int]:
    if SCAN_UNROLL:
        return ACCOUNTING_FLASH_CHUNKS
    return default_q, default_kv


@contextlib.contextmanager
def unrolled_scans():
    global SCAN_UNROLL
    prev = SCAN_UNROLL
    SCAN_UNROLL = True
    try:
        yield
    finally:
        SCAN_UNROLL = prev
