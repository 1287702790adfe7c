"""Composed pipelines ("model families"): the reference's example
applications rebuilt as compiled XLA chains."""
