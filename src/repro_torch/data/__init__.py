from .pipeline import CdfCorpus, DataConfig, SyntheticCorpus, make_train_iterator

__all__ = ["CdfCorpus", "DataConfig", "SyntheticCorpus", "make_train_iterator"]
