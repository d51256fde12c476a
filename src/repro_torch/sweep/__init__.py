"""Pareto sweep engine (port of ``repro.sweep``; see plan.py /
runner.py)."""
from .plan import (GeometryGroup, SweepPoint, PAPER_SWEEP,
                   geometry_group_key, padded_widths, paper_point_cfg,
                   paper_sweep_points, plan_sweep)
from .runner import (GroupRun, PointResult, SweepGroupFailed, SweepJournal,
                     SweepResult, group_fingerprint, make_group_train_fn,
                     member_params_state, run_pareto_sweep,
                     stack_group_operands)

__all__ = ["GeometryGroup", "SweepPoint", "PAPER_SWEEP",
           "geometry_group_key", "padded_widths", "paper_point_cfg",
           "paper_sweep_points", "plan_sweep", "GroupRun", "PointResult",
           "SweepGroupFailed", "SweepJournal", "SweepResult",
           "group_fingerprint", "make_group_train_fn",
           "member_params_state", "run_pareto_sweep",
           "stack_group_operands"]
