"""DeepRecSched's knob ladders.  The offline tuner (``tune``) arrives with
the simulator; the online controllers in ``serve.runtime`` climb these rungs.
"""
from __future__ import annotations

BATCH_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# offload-threshold hill-climb rungs (paper Fig. 10 sweep).  The last rung
# means "never offload" for the default 1000-candidate size cap.
THRESHOLD_LADDER = (1, 25, 50, 100, 150, 200, 300, 450, 700, 1001)
