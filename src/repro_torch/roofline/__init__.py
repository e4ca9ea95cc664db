from .analysis import (COLLECTIVES, H100_PEAKS, RooflineTerms, collective_bytes,
                       count_flops, model_flops_for, part_for, peaks_for,
                       step_terms)
from .analytic import step_bytes, step_flops
