from .pipeline import DataConfig, data_iterator, make_batch
