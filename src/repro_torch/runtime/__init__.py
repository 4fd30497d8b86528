"""Runtime feedback subsystem (paper §4.3).

Closes the deployment loop: instrumented executions record step telemetry
(`telemetry`), least-squares fits refine the simulator's cost model
(`calibration`), drift between simulated and observed step time triggers
plan invalidation and a warm re-search (`drift`, `feedback`), and the
observed — not simulated — runtime features are routed back into the GNN
(`telemetry.observed_sim_result` -> `core.features.featurize`).
"""
from repro_torch.runtime.calibration import (
    CalibrationProfile, fit_profile, load_profile, uniform_profile)
from repro_torch.runtime.drift import DriftDetector, DriftReport
from repro_torch.runtime.executor import execute_plan
from repro_torch.runtime.feedback import FeedbackLoop, FeedbackResult
from repro_torch.runtime.telemetry import (
    MeasurementStore, StepRecord, StepTimer, observed_sim_result)

__all__ = [
    "CalibrationProfile", "fit_profile", "load_profile", "uniform_profile",
    "DriftDetector", "DriftReport",
    "execute_plan",
    "FeedbackLoop", "FeedbackResult",
    "MeasurementStore", "StepRecord", "StepTimer", "observed_sim_result",
]
