from .base import (ALIASES, ARCH_IDS, ModelConfig, get_config,
                   reduce_for_smoke, registry)
from .shapes import SHAPES, SHAPE_ORDER, ShapeSpec, applicable, all_cells, is_subquadratic
