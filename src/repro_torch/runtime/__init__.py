from .chaos import ChaosHarness, ChaosInjected, FailureInjector, NodeFailure
from .fault import ReplicaHealthTracker

__all__ = ["ChaosHarness", "ChaosInjected", "FailureInjector",
           "NodeFailure", "ReplicaHealthTracker"]
