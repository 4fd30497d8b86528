"""Pipeline execution of the port: the stage partitioner (``stages``), the
four microbatch schedules with their timeline simulator (``schedule``), the
model adapter that cuts an LM into stage functions (``model_split``), the
eager and compiled engines that run a ``StagePlan`` as a train step
(``engine``) and the replay executor that emits a plan's step telemetry from
the cost model (``replay``)."""
from repro_torch.exec.engine import (
    CompiledPipelineRunner, PipelineRunner, StepStats, split_microbatches,
    stack_microbatches)
from repro_torch.exec.model_split import split_model
from repro_torch.exec.replay import execute_pipeline
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
    "CompiledPipelineRunner", "PipelineRunner", "StepStats", "split_microbatches", "stack_microbatches",
    "split_model",
    "execute_pipeline",
    "SCHEDULES", "Timeline", "flatten_schedule", "gpipe_schedule",
    "interleaved_1f1b_schedule", "make_schedule", "max_feasible_micro",
    "one_f_one_b_schedule", "peak_stash", "schedule_step_cost",
    "simulate_schedule", "stage_sync_time", "timeline_to_simresult",
    "validate_schedule", "zero_bubble_schedule",
    "PipelineInfeasible", "StagePlan", "StageSpec", "build_stage_plan",
    "pipeline_spine", "vote_schedule",
]
