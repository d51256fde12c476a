from .analysis import HW, Hardware, RooflineReport, roofline_report
from .counter import CountingMesh, StepAnalysis, count_step

__all__ = ["CountingMesh", "HW", "Hardware", "RooflineReport",
           "StepAnalysis", "count_step", "roofline_report"]
