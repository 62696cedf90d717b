"""The scheduling side of the port: its own copy of the reference's
simulator core (performance model, task profiles, interference, jobs
and cluster, Theorem 1, Algorithm 2 with its vectorized decision paths,
the heap and scan event engines, the seven policies, the trace
generators and the sweep), the calibration artifact, and the
co-scheduling measurements on the device (``core.coschedule``, which
imports the executor and PyTorch, and is not imported here). Exports
what the reference's ``core`` exports, less ``TPU_V5E``."""
from .batch_scaling import (DonorScaledConfig, SharingConfig,
                            best_sharing_config,
                            best_sharing_config_donor_scaled)
from .calibration import (CALIBRATION_VERSION, MeasuredTaskProfile,
                          load_artifact, perf_params_from_artifact,
                          profiles_from_artifact, run_calibration,
                          save_artifact)
from .engine import ENGINES, HeapEngine, ScanEngine
from .faults import FaultModel
from .interference import (InterferenceModel, paper_interference_model,
                           structural_xi)
from .job import ClusterState, Job, JobState
from .pair import PairDecision, PairJob, best_pair_schedule, pair_timeline
from .pair_batch import (DonorBatch, DonorDecisions,
                         best_sharing_config_batched, best_sharing_configs,
                         job_candidate_table)
from .perf_model import (GPU_2080TI, HardwareSpec, PerfParams,
                         derive_perf_params, fit_comp_params, infer_xi,
                         ring_allreduce_bytes, t_iter_at_workers)
from .schedulers import (ALL_POLICIES, FIFO, SJF, SJF_BSBF, SJF_FFS, SRSF,
                         PolluxLike, Tiresias, make_scheduler)
from .simulator import SchedulerBase, SimResults, Simulator
from .sweep import (ScenarioSpec, grid, run_scenario, run_sweep,
                    rows_by_policy, summary_table, write_csv, write_json)
from .tasks import PAPER_TASK_PROFILES, TaskProfile, profile_from_arch
from .trace import (TraceConfig, calibrated_trace, datacenter_trace,
                    generate_trace, philly_trace, physical_trace,
                    simulation_trace)

__all__ = [
    "ALL_POLICIES", "CALIBRATION_VERSION", "ClusterState",
    "DonorBatch", "DonorDecisions", "DonorScaledConfig",
    "ENGINES", "FIFO", "FaultModel", "GPU_2080TI",
    "HardwareSpec", "HeapEngine", "InterferenceModel", "Job", "JobState",
    "MeasuredTaskProfile", "PAPER_TASK_PROFILES",
    "PairDecision", "PairJob", "PerfParams", "PolluxLike", "SJF",
    "SJF_BSBF", "SRSF", "SJF_FFS", "ScanEngine", "ScenarioSpec",
    "SchedulerBase", "SharingConfig", "SimResults", "Simulator",
    "TaskProfile", "Tiresias", "TraceConfig",
    "best_pair_schedule", "best_sharing_config",
    "best_sharing_config_batched", "best_sharing_config_donor_scaled",
    "best_sharing_configs", "calibrated_trace",
    "datacenter_trace", "derive_perf_params",
    "fit_comp_params", "generate_trace", "grid", "infer_xi",
    "job_candidate_table", "load_artifact", "make_scheduler",
    "pair_timeline", "paper_interference_model",
    "perf_params_from_artifact", "philly_trace", "physical_trace",
    "profile_from_arch", "profiles_from_artifact", "ring_allreduce_bytes",
    "rows_by_policy",
    "run_calibration", "run_scenario", "run_sweep", "save_artifact",
    "simulation_trace", "structural_xi", "summary_table",
    "t_iter_at_workers", "write_csv", "write_json",
]
