"""Parallelism over a device mesh: the sharding rules, the mesh's
collectives, gradient compression, the sequence-parallel SSD scan and the
GPipe pipeline (the JAX package's ``parallel``)."""
from . import collectives, sharding
from .compression import (compress_tree, make_error_feedback_compressor,
                          compression_ratio)
from .seqparallel import seq_parallel_ssd
from .pipeline import pipeline_forward, bubble_fraction
