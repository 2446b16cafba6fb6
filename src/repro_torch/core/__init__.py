"""FaST-GShare core: the paper's spatio-temporal sharing control plane
(the port's copy of ``repro.core``; only the imports differ)."""

from repro_torch.core.cluster import Cluster, Node, Simulator
from repro_torch.core.manager import Token, TokenScheduler, fair_share_baseline
from repro_torch.core.maximal_rectangles import MaxRectsNode, MaxRectsPool, Placement
from repro_torch.core.model_sharing import MemoryModel, ModelStore, pytree_nbytes
from repro_torch.core.profiler import (ProfileDB, TrialResult, measure_callable_trial,
                                 profile_function, simulate_trial)
from repro_torch.core.resources import SCALE, Alloc, Rect
from repro_torch.core.scaling import (FunctionPodQueue, ProfilePoint, ScaleDecision,
                                heuristic_scale, processing_gap)
from repro_torch.core.slo import SLORecorder
from repro_torch.core.workload import (PAPER_ZOO, Request, ServiceCurve,
                                 diurnal_trace, poisson_arrivals,
                                 predicted_rps, trace_arrivals)

__all__ = [
    "Alloc", "Rect", "SCALE",
    "TokenScheduler", "Token", "fair_share_baseline",
    "MaxRectsPool", "MaxRectsNode", "Placement",
    "ModelStore", "MemoryModel", "pytree_nbytes",
    "ProfilePoint", "ScaleDecision", "FunctionPodQueue",
    "heuristic_scale", "processing_gap",
    "ProfileDB", "TrialResult", "profile_function", "simulate_trial",
    "measure_callable_trial",
    "Cluster", "Node", "Simulator",
    "SLORecorder",
    "ServiceCurve", "PAPER_ZOO", "Request",
    "poisson_arrivals", "trace_arrivals", "diurnal_trace", "predicted_rps",
]
