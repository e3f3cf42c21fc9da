"""The distributed runtime on ``torch.distributed``: sharding rules and their
DTensor placements, ring collectives with overlap, and the GPipe schedule.
Meshes are built by ``launch/mesh.py``; the compressed all-reduce lives in
``train/grad_compress.py``, the expert-parallel MoE in ``layers/moe.py``
and the elastic restore in ``train/checkpoint.py``."""
