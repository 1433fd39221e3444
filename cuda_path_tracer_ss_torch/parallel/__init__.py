"""Rendering over several processes: meshes and collectives over
``torch.distributed`` (``mesh``), the eager engine's sharded renders
(``sharding``) and the multi-device certification run (``dryrun``). The
kernel engines' sharded entries live beside their single-device ones in
``ops/cuda`` and ``render/bidir.py``."""
