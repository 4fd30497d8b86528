"""Pipeline planning of the port: the stage partitioner (``stages``) and the
four microbatch schedules with their timeline simulator (``schedule``), both
numpy. The engines that run a ``StagePlan`` are a later slice."""
from repro_torch.exec.schedule import (
    SCHEDULES, Timeline, flatten_schedule, gpipe_schedule,
    interleaved_1f1b_schedule, make_schedule, max_feasible_micro,
    one_f_one_b_schedule, peak_stash, schedule_step_cost, simulate_schedule,
    stage_sync_time, timeline_to_simresult, validate_schedule,
    zero_bubble_schedule)
from repro_torch.exec.stages import (
    PipelineInfeasible, StagePlan, StageSpec, build_stage_plan, pipeline_spine,
    vote_schedule)

__all__ = [
    "SCHEDULES", "Timeline", "flatten_schedule", "gpipe_schedule",
    "interleaved_1f1b_schedule", "make_schedule", "max_feasible_micro",
    "one_f_one_b_schedule", "peak_stash", "schedule_step_cost",
    "simulate_schedule", "stage_sync_time", "timeline_to_simresult",
    "validate_schedule", "zero_bubble_schedule",
    "PipelineInfeasible", "StagePlan", "StageSpec", "build_stage_plan",
    "pipeline_spine", "vote_schedule",
]
