from .engine import (DecodeStep, EngineConfig, Request, ServeEngine, greedy,
                     seed_decode_cache, seed_decode_cache_)
