from .engine import (DecodeStep, EngineConfig, Request, ServeEngine, greedy,
                     pad_batch, seed_decode_cache, seed_decode_cache_)
