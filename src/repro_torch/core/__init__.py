"""numpy/scipy core of the port, and its sweep front end.

Layers:
  graph          — job dependency graph (§III/§IV-A)
  power          — DVFS LUTs, cluster presets, the stacked LUTTable
  ilp            — paper ILP + exact-makespan MILP (§IV-B)
  arrays         — batch geometry shared by the vector and torch engines
  block_detector — report messages + ski-rental debounce (§V-A, §VII-A2)
  heuristic      — Algorithm 1 online controller (§V-B)
  simulator      — policy-agnostic discrete-event cluster simulator (§VI);
                   policies live in repro_torch.policies
  batchsim       — float64 vector batch simulator (executor="vector")
  sweep          — batched (graph, bound, policy) scenario engine with
                   padded mixed-shape bucketing onto the torch engine
  scenarios      — seeded ScenarioFamily generators
  workloads      — Listing-2 example, NPB analogues, random layered /
                   fork-join generators, pipeline/MoE graphs

Each module is the port's own copy of the reference's numpy module of
the same name (never imported from it).
"""

from .batchsim import BatchSimulator, simulate_batch
from .block_detector import (DistributeMessage, NodeState, ReportManager,
                             ReportMessage, blocked_report, running_report)
from .graph import Job, JobDependencyGraph, JobId
from .heuristic import PowerDistributionController
from .ilp import (PowerAssignment, assignment_peak_power,
                  build_makespan_milp, equal_share_assignment,
                  solve_paper_ilp)
from .power import (NodeSpec, PowerLUT, PowerState, arndale_like_lut,
                    heterogeneous_cluster, homogeneous_cluster, job_time,
                    max_useful_cluster_bound, min_feasible_cluster_bound,
                    odroid_like_lut, progress_rate, tpu_v5e_lut)
from .results import SimResult
from .scenarios import (FamilyMember, ScenarioFamily, lm_family,
                        mixed_family, npb_family, random_layered_family)
from .simulator import Simulator, simulate
from .sweep import (MapRecord, Scenario, SweepEngine, SweepRecord,
                    SweepResult, compare_policies, scenario_grid)
from .workloads import (cg_like, ep_like, fork_join_graph, is_like,
                        layered_dag, listing2_graph, listing2_random,
                        listing2_uniform, mixed_members, moe_step_graph,
                        pipeline_graph)

__all__ = [k for k in dir() if not k.startswith("_")]
