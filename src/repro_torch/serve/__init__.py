from .engine import EngineConfig, Request, ServeEngine, seed_decode_cache
