from .pipeline import DataConfig, SyntheticCorpus, make_train_iterator

__all__ = ["DataConfig", "SyntheticCorpus", "make_train_iterator"]
