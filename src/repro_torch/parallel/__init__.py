"""Parallelism over a device mesh: the sharding rules, the mesh's
collectives and the sequence-parallel SSD scan (the JAX package's
``parallel``; its gradient compression and pipeline are not ported yet)."""
from . import collectives, sharding
from .seqparallel import seq_parallel_ssd
