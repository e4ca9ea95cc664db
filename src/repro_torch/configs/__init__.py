from .base import (ALIASES, ARCH_IDS, ModelConfig, get_config,
                   reduce_for_smoke, registry)
