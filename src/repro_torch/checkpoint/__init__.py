"""Checkpointing (`repro/checkpoint`) in the reference's on-disk format."""
from .manager import CheckpointManager, PreemptionHandler
