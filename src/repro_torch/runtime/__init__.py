from .chaos import ChaosHarness, ChaosInjected, FailureInjector, NodeFailure
from .fault import ReplicaHealthTracker, TrainSupervisor
from .straggler import StepWatchdog, run_with_backup
from .tracker import (CallbackTracker, CompositeTracker, JsonlTracker,
                      NoopTracker, PrintTracker, Tracker)

__all__ = ["CallbackTracker", "ChaosHarness", "ChaosInjected",
           "CompositeTracker", "FailureInjector", "JsonlTracker",
           "NodeFailure", "NoopTracker", "PrintTracker",
           "ReplicaHealthTracker", "StepWatchdog", "TrainSupervisor", "Tracker",
           "run_with_backup"]
